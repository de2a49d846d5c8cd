"""The fused BAM ingest's record scan on the card: hand-written CUDA kernels
and their plain version.

The kernels (csrc/bam_scan.cu) walk the record chain of one inflated
segment where the inflate kernel left it in card memory and scan every
record: the work of the host's ct_stats_scan (native/bamdecode.cpp
run_stats_pipeline and scan_chunk_records), whose outputs they give bit
for bit. They replace no TPU kernel: the JAX package scans records on the
host. The source is compiled with nvcc for sm_90a into a shared library
with a plain C interface on first use (ops/cuda_build.py) and bound with
ctypes; a scan is six launches of its five kernels (speculate, the
stitch's check and walk, records twice: analyse and emit, and the fold
between them).

`scan_segment(data, start, end, n_ref, skip_mask, req_mask, read_filter)`
scans the complete records of the uint8 tensor `data` from `start` (the
first record's start) to `end`. For a CUDA tensor the kernels do it on the
current stream of its card, and the outputs come back in pinned host
memory; for a CPU tensor the plain version, `bam_scan_reference`, does the
same three steps as tensor code and a Python walk over the regions. Both
return a SegmentScan.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import cuda_build

SOURCE = cuda_build.SOURCES[2]  # csrc/bam_scan.cu
REGION = 1 << 16        # bytes a region of the speculation
CAP = (REGION - 1) // 37 + 1  # record starts a region can hold
CHUNK_SHIFT = 15
CHUNK = 1 << CHUNK_SHIFT  # the host scan's chunk: records a run restarts at
RUN_WORDS = 9    # tid, primary, nonsupp, all, nm, indel, blocks, two f64
CHUNK_WORDS = 8  # n_primary, nm_missing, sorted, first, last, err, runs, 0
# records, end_off, err, stop, regions walked again, regions walked in
# sequence, the first of those (0: none), 0
STITCH_WORDS = 8
# how the chain stopped (the stitch's stop word)
STOP_END, STOP_ZERO, STOP_PAST_END, STOP_TOO_SHORT = range(4)
# a record's flags
PRIMARY, NONSUPP, HAS_IDV, COUNTED, ERROR = 1, 2, 4, 8, 16
# the launches, by csrc/bam_scan.cu enum Step
STEPS = ("speculate", "stitch", "stitch_walk", "analyse", "fold", "emit")
SECTOR = 32  # bytes of the card's smallest memory access (bytes_read)

# scans by the CUDA kernels (one a segment: its six launches); the plain
# version does not count
bam_scan_launches = 0

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()

_vp = ctypes.c_void_p
_i64 = ctypes.c_longlong
_i32 = ctypes.c_int


class ScanArgs(ctypes.Structure):
    """csrc/bam_scan.cu's ScanArgs: one segment's buffers and settings."""

    _fields_ = [("data", _vp), ("start", _i64), ("end", _i64),
                ("n_regions", _i64), ("n_ref", _i32), ("skip_mask", _i32),
                ("req_mask", _i32), ("use_filter", _i32), ("min_mapq", _i32),
                ("min_aligned_length", _i64),
                ("min_aligned_percent", ctypes.c_float),
                ("min_identity", ctypes.c_float),
                ("list", _vp), ("first", _vp), ("exit_", _vp), ("cnt", _vp),
                ("entry", _vp), ("rank", _vp), ("count", _vp), ("base", _vp),
                ("stitch", _vp), ("n_records", _i64), ("rec_off", _vp),
                ("flags", _vp), ("tid", _vp), ("nblk", _vp), ("nm", _vp),
                ("ind", _vp), ("idv", _vp), ("blk_off", _vp), ("btid", _vp),
                ("bstart", _vp), ("bend", _vp), ("runs", _vp),
                ("chunks", _vp)]


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(cuda_build.build(SOURCE))
            lib.bam_scan_launch.restype = _i32
            lib.bam_scan_launch.argtypes = [_i32, ctypes.POINTER(ScanArgs),
                                            _i32, _vp]
            _check_layout(lib)
            _lib = lib
    return _lib


def _check_layout(lib):
    if (lib.bam_scan_region_bytes() != REGION
            or lib.bam_scan_region_cap() != CAP
            or lib.bam_scan_args_bytes() != ctypes.sizeof(ScanArgs)):
        raise RuntimeError("csrc/bam_scan.cu and ops/bam_scan.py disagree "
                           "on the scan's layout")


def filter_fields(read_filter):
    """(use, min_mapq, min_aligned_length, min_aligned_percent,
    min_identity) of a readfilter.FilterParams's single-read thresholds
    as the scan takes them, the host scan's values."""
    if read_filter is None:
        return 0, 255, 0, 0.0, 0.0
    from ..io.native import read_filter_values
    return (1, *read_filter_values(read_filter))


@dataclass
class SegmentScan:
    """One segment's scan, in host memory: the filtered blocks in record
    order, the statistic runs in chunk order (int64[n, RUN_WORDS], the two
    identity sums as float64 bits), the chunks' words (int64[n,
    CHUNK_WORDS]) and the stitch's words; `timing` holds the card's
    milliseconds by step (CUDA events just around each step's launches,
    and the outputs' copy to the host) when they were asked for; `tail`
    the bytes from end_off to the end, the next segment's carry."""

    btid: np.ndarray
    bstart: np.ndarray
    bend: np.ndarray
    runs: np.ndarray
    chunks: np.ndarray
    stitch: np.ndarray
    timing: dict | None = None
    tail: np.ndarray | None = None  # the bytes after the last record

    @property
    def n_records(self) -> int:
        return int(self.stitch[0])

    @property
    def end_off(self) -> int:
        return int(self.stitch[1])

    @property
    def stop(self) -> int:
        return int(self.stitch[3])

    @property
    def regions_walked(self) -> int:
        return int(self.stitch[4])

    @property
    def regions_in_sequence(self) -> int:
        """Regions the stitch walked in order after its parallel check
        (the kernels'; 0 from the plain version)."""
        return int(self.stitch[5])

    def scalars(self) -> np.ndarray:
        """ct_stats_scan's ten scalars, the chunks merged as
        run_stats_pipeline merges them."""
        c = self.chunks
        err = 0
        bad = np.flatnonzero(c[:, 5])
        if bad.size:
            err = (int(bad[0]) << CHUNK_SHIFT) + int(c[bad[0], 5])
        elif self.stitch[2]:
            err = int(self.stitch[2])
        sorted_ = bool(c[:, 2].all())
        seen = c[c[:, 3] >= 0]
        first_tid = last_tid = -1
        if seen.shape[0]:
            first_tid, last_tid = int(seen[0, 3]), int(seen[-1, 4])
            if (seen[1:, 3] < seen[:-1, 4]).any():
                sorted_ = False
        return np.array([self.n_records, self.end_off, self.btid.size,
                         int(c[:, 0].sum()), int(c[:, 1].sum()),
                         int(sorted_), first_tid, last_tid, err, 0],
                        np.int64)


def scan_segment(data, start, end, n_ref, skip_mask, req_mask,
                 read_filter=None, timing=False):
    """SegmentScan of the complete records of `data` (uint8[]) in [start,
    end), `start` a record's start.

    A CUDA tensor goes through the kernels, on the current stream of its
    card, whose outputs are copied into pinned host tensors on that
    stream (`timing`: the steps' milliseconds by CUDA events); a CPU
    tensor through the plain version."""
    global bam_scan_launches
    if data.dtype != torch.uint8 or data.dim() != 1 \
            or not data.is_contiguous():
        raise ValueError("bam_scan takes a contiguous uint8[] tensor")
    start, end = int(start), int(end)
    if not 0 <= start <= end <= data.numel():
        raise ValueError(f"bam_scan: [{start}, {end}) is not within the "
                         f"{data.numel()} bytes")
    if data.device.type == "cpu":
        return bam_scan_reference(data, start, end, n_ref, skip_mask,
                                  req_mask, read_filter)
    if data.device.type != "cuda":
        raise ValueError(f"bam_scan: unsupported device {data.device}")
    lib = _load()
    dev = data.device
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(step, args):
        err = lib.bam_scan_launch(step, ctypes.byref(args), dev.index,
                                  stream)
        if err != 0:
            where = ("setting the card", "the launch")[min(err // 1000, 2) - 1]
            raise RuntimeError(f"bam_scan kernel ({STEPS[step]}) failed on "
                               f"{dev} at {where}: CUDA error {err % 1000}")
    out = run_steps(data, start, end, n_ref, skip_mask, req_mask,
                    read_filter, launch, timing)
    with _count_lock:
        bam_scan_launches += 1
    return out


def run_steps(data, start, end, n_ref, skip_mask, req_mask, read_filter,
              launch, timing=False):
    """The scan's steps over `data`'s device, each step through
    launch(step, ScanArgs): the kernels on a card (scan_segment), or the
    kernels' host build on the CPU (the tests). Allocates every buffer
    with torch.empty on that device and waits for the card twice before
    the end: for the record count, then for the block count and the
    chunks' words together (the fold runs before the block scan), which
    size the blocks, and whose run counts gather the runs on the device.
    The bytes after the last complete record come back with the outputs
    (SegmentScan.tail)."""
    dev = data.device
    cuda = dev.type == "cuda"
    n_regions = -(-(end - start) // REGION)
    args = ScanArgs()
    keep = []  # the buffers args points into
    ms = {} if cuda and timing else None

    def buf(name, n, dtype):
        t = torch.empty(max(int(n), 1), dtype=dtype, device=dev)
        keep.append(t)
        setattr(args, name, t.data_ptr())
        return t[:int(n)]

    @contextlib.contextmanager
    def timed(name):
        """The card's milliseconds of what the block enqueues, by CUDA
        events just around it (no host gap between steps counted)."""
        if ms is None:
            yield
            return
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        yield
        ev[1].record()
        ms[name] = ev

    def to_host(t):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
        h.copy_(t, non_blocking=cuda)
        return h

    def wait():
        if cuda:
            torch.cuda.current_stream(dev).synchronize()

    use, mapq, alen, apct, ident = filter_fields(read_filter)
    args.data = data.data_ptr()
    args.start, args.end, args.n_regions = start, end, n_regions
    args.n_ref, args.skip_mask, args.req_mask = int(n_ref), skip_mask, \
        req_mask
    args.use_filter, args.min_mapq = use, mapq
    args.min_aligned_length = alen
    args.min_aligned_percent, args.min_identity = apct, ident
    buf("list", n_regions * CAP, torch.int32)
    for name, dtype in (("first", torch.int64), ("exit_", torch.int64),
                        ("cnt", torch.int32), ("entry", torch.int64),
                        ("rank", torch.int32), ("count", torch.int32),
                        ("base", torch.int64)):
        buf(name, n_regions, dtype)
    stitch = buf("stitch", STITCH_WORDS, torch.int64)
    if n_regions:
        for step in range(3):  # speculate, the stitch's check and walk
            with timed(STEPS[step]):
                launch(step, args)
        stitch_h = stitch.cpu().numpy()
    else:
        stitch_h = np.array([0, start, 0, STOP_END, 0, 0, 0, 0], np.int64)
    n = int(stitch_h[0])
    args.n_records = n
    buf("rec_off", n, torch.int64)
    buf("flags", n, torch.uint8)
    buf("tid", n, torch.int32)
    nblk = buf("nblk", n, torch.int32)
    for name, dtype in (("nm", torch.int64), ("ind", torch.int64),
                        ("idv", torch.float64)):
        buf(name, n, dtype)
    n_chunks = -(-n // CHUNK)
    runs = buf("runs", n_chunks * CHUNK * RUN_WORDS, torch.int64)
    chunks = buf("chunks", n_chunks * CHUNK_WORDS, torch.int64)
    for step in (3, 4):  # analyse, fold
        with timed(STEPS[step]):
            if n:
                launch(step, args)
    with timed("block_scan"):
        incl = torch.cumsum(nblk, 0)
        blk_off = incl - nblk
    keep.append(blk_off)
    args.blk_off = blk_off.data_ptr() if n else 0
    sizes = to_host(torch.cat([incl[-1:], chunks]))
    wait()
    n_blocks = int(sizes[0]) if n else 0
    chunks_h = sizes[int(n > 0):].numpy().reshape(n_chunks, CHUNK_WORDS)
    btid = buf("btid", n_blocks, torch.int32)
    bstart = buf("bstart", n_blocks, torch.int32)
    bend = buf("bend", n_blocks, torch.int32)
    with timed("emit"):
        if n:
            launch(5, args)
    with timed("d2h"):
        # chunk c's runs lie from its first record's slot: gathered on the
        # device in one copy, by the chunk words' run counts
        slots = runs.view(-1, RUN_WORDS)
        kept = torch.cat([slots[c * CHUNK:c * CHUNK + int(k)]
                          for c, k in enumerate(chunks_h[:, 6])]) \
            if n_chunks else slots
        outs = [to_host(t) for t in (btid, bstart, bend, kept,
                                     data[int(stitch_h[1]):end])]
    wait()
    if ms is not None:
        ms = {k: a.elapsed_time(b) for k, (a, b) in ms.items()}
    return SegmentScan(outs[0].numpy(), outs[1].numpy(), outs[2].numpy(),
                       outs[3].numpy(), chunks_h, stitch_h, ms,
                       outs[4].numpy())


# ---- the plain version

def _u32(d, pos):
    """Little-endian uint32 at each of pos (int64 tensor) in d (uint8)."""
    p = pos.long()
    return (d[p].long() | d[p + 1].long() << 8 | d[p + 2].long() << 16
            | d[p + 3].long() << 24)


def _as_i32(x):
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


def _plausible(d, q, end, n_ref):
    """csrc/bam_scan.cu's plausible() at each offset of q."""
    ok = q + 36 <= end
    qq = torch.where(ok, q, 0)
    bs = _u32(d, qq)
    ok &= (bs >= 33) & (qq + 4 + bs <= end)
    ref, nref = _as_i32(_u32(d, qq + 4)), _as_i32(_u32(d, qq + 24))
    ok &= (ref >= -1) & (ref < n_ref) & (nref >= -1) & (nref < n_ref)
    l_rn = d[qq + 12].long()
    l_seq = _as_i32(_u32(d, qq + 20))
    ok &= (l_rn >= 1) & (l_seq >= 0)
    n_cig = d[qq + 16].long() | d[qq + 17].long() << 8
    need = 32 + l_rn + 4 * n_cig + torch.div(l_seq + 1, 2,
                                              rounding_mode="floor") + l_seq
    ok &= need <= bs
    name_end = torch.where(ok, qq + 36 + l_rn - 1, 0)
    return ok & (d[name_end] == 0)


def _speculate(d, start, end, n_regions, n_ref):
    """Step (a) over all regions at once: (first, exit, starts), starts a
    list of each region's chain starts (int64 numpy)."""
    b = torch.arange(n_regions, dtype=torch.int64)
    r0 = start + b * REGION
    r1 = torch.clamp(r0 + REGION, max=end)
    first = torch.full((n_regions,), -1, dtype=torch.int64)
    if n_regions:
        first[0] = start
    todo = torch.arange(1, n_regions)
    lo = r0[todo]
    while todo.numel():
        q = lo[:, None] + torch.arange(1024)
        hit = (q < r1[todo][:, None]) & _plausible(
            d, torch.where(q < end, q, 0), end, n_ref) & (q < end)
        anyh = hit.any(1)
        first[todo[anyh]] = q[anyh, hit[anyh].int().argmax(1)]
        lo = lo + 1024
        keep = ~anyh & (lo < r1[todo])
        todo, lo = todo[keep], lo[keep]
    # walk every chain in step, a record a step
    pos = first.clone()
    active = pos >= 0
    steps = []
    while True:
        active &= (pos < r1) & (pos + 4 <= end)
        if not active.any():
            break
        bs = _u32(d, torch.where(active, pos, 0))
        active &= (bs != 0) & (pos + 4 + bs <= end) & (bs >= 33)
        steps.append(torch.where(active, pos, -1))
        pos = torch.where(active, pos + 4 + bs, pos)
    grid = (torch.stack(steps, 1) if steps
            else torch.zeros((n_regions, 0), dtype=torch.int64)).numpy()
    starts = [row[row >= 0] for row in grid]
    return first.numpy(), pos.numpy(), starts


def _stitch(d, start, end, first, exit_, starts):
    """Step (b): the true chain region by region from the anchor, as
    csrc/bam_scan.cu stitch_tile. Returns (record offsets, stitch words)."""
    dn = d.numpy()

    def u32(p):
        return int.from_bytes(dn[p:p + 4].tobytes(), "little")

    e, nrec, slow, err, stop = start, 0, 0, 0, STOP_END
    offs = []
    while True:
        if e + 4 > end:
            end_off = e
            break
        b = (e - start) >> 16
        r0 = start + b * REGION
        r1 = min(r0 + REGION, end)
        f, sp = int(first[b]), starts[b]
        k = -1
        if f == e:
            k = 0
        elif 0 <= f < e:
            j = int(np.searchsorted(sp, e))
            k = j if j < sp.size and sp[j] == e else -1
        if k >= 0:
            offs.append(sp[k:])
            x = int(exit_[b])
        else:
            slow += 1
            pos, walked = e, []
            while pos < r1 and pos + 4 <= end:
                bs = u32(pos)
                if bs == 0 or pos + 4 + bs > end or bs < 33:
                    break
                walked.append(pos)
                pos += 4 + bs
                if pos < r1 and f >= 0 and pos > f:
                    j = int(np.searchsorted(sp, pos))
                    if j < sp.size and sp[j] == pos:
                        walked.extend(sp[j:].tolist())
                        pos = int(exit_[b])
                        break
            offs.append(np.asarray(walked, np.int64))
            x = pos
        nrec += offs[-1].size
        e = x
        if x < r1:
            end_off = x
            if x + 4 <= end:
                bs = u32(x)
                if bs == 0:
                    stop = STOP_ZERO
                elif x + 4 + bs > end:
                    stop = STOP_PAST_END
                else:
                    stop, err = STOP_TOO_SHORT, nrec + 1
            break
    rec = (np.concatenate(offs) if offs else np.zeros(0, np.int64))
    return rec, np.array([nrec, end_off, err, stop, slow, 0, 0, 0], np.int64)


def _aux_nm(d, aux, rec, rec_len, spans=None):
    """scan_aux_tags' NM search for every record at once, a tag a step:
    (nm, -1 when absent; bad, a malformed or truncated tag). `spans` (a
    list) gains the (lo, hi) byte ranges that the search reads: each
    tag's header and the value bytes it looks at."""
    n = aux.numel()

    def read(lo, hi, m):
        if spans is not None:
            spans.append((torch.where(m, lo, 0), torch.where(m, hi, 0)))
    nm = torch.full((n,), -1, dtype=torch.int64)
    bad = torch.zeros(n, dtype=torch.bool)
    aux = torch.where((aux < 0) | (aux > rec_len), rec_len, aux)
    live = torch.ones(n, dtype=torch.bool)
    size_of = {ord(c): s for c, s in (("A", 1), ("C", 1), ("c", 1),
                                      ("S", 2), ("s", 2), ("I", 4),
                                      ("i", 4))}
    while True:
        live &= aux + 3 <= rec_len
        if not live.any():
            return nm, bad
        at = rec + torch.where(live, aux, 0)
        read(at, at + 3, live)
        t0, t1, typ = d[at].long(), d[at + 1].long(), d[at + 2].long()
        aux = torch.where(live, aux + 3, aux)
        val = torch.zeros(n, dtype=torch.int64)
        has = torch.zeros(n, dtype=torch.bool)
        known = torch.zeros(n, dtype=torch.bool)
        for code, size in size_of.items():
            m = live & (typ == code)
            known |= m
            short = m & (aux + size > rec_len)
            bad |= short
            m &= ~short
            p = rec + torch.where(m, aux, 0)
            read(p, p + size, m)
            if size == 1:
                v = d[p].long()
                if code == ord("c"):
                    v = torch.where(v >= 128, v - 256, v)
            elif size == 2:
                v = d[p].long() | d[p + 1].long() << 8
                if code == ord("s"):
                    v = torch.where(v >= 1 << 15, v - (1 << 16), v)
            else:
                v = _u32(d, p)
                if code == ord("i"):
                    v = _as_i32(v)
            val = torch.where(m, v, val)
            has |= m
            aux = torch.where(m, aux + size, aux)
            live &= ~short
        m = live & (typ == ord("f"))
        known |= m
        aux = torch.where(m, aux + 4, aux)
        m = live & ((typ == ord("Z")) | (typ == ord("H")))
        known |= m
        z0 = rec + aux
        zl = m.clone()
        while zl.any():
            p = rec + torch.where(zl, aux, 0)
            zl &= (aux < rec_len) & (d[torch.clamp(p, max=d.numel() - 1)]
                                     != 0)
            aux = torch.where(zl, aux + 1, aux)
        aux = torch.where(m, aux + 1, aux)
        read(z0, torch.clamp(rec + aux, max=d.numel()), m)
        m = live & (typ == ord("B"))
        known |= m
        short = m & (aux + 5 > rec_len)
        bad |= short
        m &= ~short
        p = rec + torch.where(m, aux, 0)
        read(p, p + 5, m)
        sub = d[p].long()
        cnt = _u32(d, p + 1)
        esz = torch.where((sub == ord("c")) | (sub == ord("C")), 1,
                          torch.where((sub == ord("s")) | (sub == ord("S")),
                                      2, 4))
        aux = torch.where(m, aux + 5 + cnt * esz, aux)
        live &= ~short
        unknown = live & ~known
        bad |= unknown
        live &= ~unknown
        found = has & (t0 == ord("N")) & (t1 == ord("M"))
        nm = torch.where(found, val, nm)
        live &= ~found


def _analyse(d, off, n_ref, skip_mask, req_mask, read_filter, spans=None):
    """Step (c)'s per-record work for every record at once: (flags, tid,
    nblk, nm, ind, idv, the CIGAR ops of the counted records as (record,
    op, length) in record order). `spans` (a list) gains the (lo, hi)
    byte ranges that the work reads: each record's fixed fields from
    block_size to l_seq, and the CIGAR and the aux tags up to NM of each
    record the flags let through."""
    n = off.numel()
    rec = off + 4
    rec_len = _u32(d, off)
    tid = _as_i32(_u32(d, rec))
    l_rn = d[rec + 8].long()
    n_cig = d[rec + 12].long() | d[rec + 13].long() << 8
    flag = d[rec + 14].long() | d[rec + 15].long() << 8
    primary = (flag & 0x900) == 0
    nonsupp = (flag & 0x800) == 0
    fl = primary.to(torch.uint8) * PRIMARY + nonsupp.to(torch.uint8) * NONSUPP
    cand = ((flag & skip_mask) == 0) & ((flag & req_mask) == req_mask) & \
        ((flag & 4) == 0)
    l_seq = _as_i32(_u32(d, rec + 16))
    geom = cand & ((l_seq < 0) | (32 + l_rn + 4 * n_cig > rec_len))
    ok = cand & ~geom
    if spans is not None:
        cig0 = torch.where(ok, rec + 32 + l_rn, 0)
        spans += [(off, rec + 20), (cig0, cig0 + torch.where(ok, 4 * n_cig,
                                                             0))]
    # the CIGAR ops of the records that get that far
    ncig_ok = torch.where(ok, n_cig, 0)
    owner = torch.repeat_interleave(torch.arange(n), ncig_ok)
    first_op = torch.cumsum(ncig_ok, 0) - ncig_ok
    k = torch.arange(owner.numel()) - first_op[owner]
    word = _u32(d, rec[owner] + 32 + l_rn[owner] + 4 * k)
    op, ln = word & 0xF, word >> 4
    is_m = (op == 0) | (op == 7) | (op == 8)
    is_id = (op == 1) | (op == 2)
    nb = torch.zeros(n, dtype=torch.int64).index_add_(0, owner, is_m.long())
    a_cov = torch.zeros(n, dtype=torch.int64).index_add_(
        0, owner, torch.where(is_m | is_id, ln, 0))
    ind = torch.zeros(n, dtype=torch.int64).index_add_(
        0, owner, torch.where(is_id, ln, 0))
    l_seq32 = torch.where(ok, l_seq, 0)
    half = l_seq32 + 1  # (l_seq + 1) / 2 in int32, as the host computes it
    half = torch.div(_as_i32(half & 0xFFFFFFFF), 2, rounding_mode="trunc")
    aux = 32 + l_rn + 4 * n_cig + half + l_seq32
    nm, bad = _aux_nm(d, torch.where(ok, aux, rec_len),
                      rec, torch.where(ok, rec_len, 0), spans)
    err = geom | (ok & bad)
    ok &= ~bad
    if read_filter is not None:
        use, mapq_min, alen, apct, ident = filter_fields(read_filter)
        mapq = d[rec + 9].long()
        keep = torch.ones(n, dtype=torch.bool)
        if mapq_min != 255:
            keep &= (mapq >= mapq_min) & (mapq != 255)
        af = a_cov.to(torch.float32)
        frac = af / l_seq.to(torch.float32)
        identity = 1.0 - nm.to(torch.float32) / af
        keep &= (a_cov >= alen) & (frac >= torch.tensor(apct)) & \
            (identity >= torch.tensor(ident))
        ok &= keep
    rng = (tid < 0) | (tid >= n_ref)
    err |= ok & rng
    counted = ok & ~rng
    has_idv = counted & (nm >= 0) & (a_cov > 0)
    idv = torch.where(has_idv, (a_cov - nm).double()
                      / torch.where(has_idv, a_cov, 1).double(),
                      torch.zeros((), dtype=torch.float64))
    fl = fl + counted.to(torch.uint8) * COUNTED + \
        has_idv.to(torch.uint8) * HAS_IDV + err.to(torch.uint8) * ERROR
    nb = torch.where(counted, nb, 0)
    keep_op = counted[owner]
    cig = (owner[keep_op], op[keep_op], ln[keep_op])
    return fl, tid, nb, nm, ind, idv, cig


def _emit(d, off, tid, cig):
    """The counted records' blocks in record order: (btid, bstart, bend)."""
    owner, op, ln = cig
    pos = _as_i32(_u32(d, off + 8))
    ref = torch.where((op == 0) | (op == 7) | (op == 8) | (op == 2)
                      | (op == 3), ln, 0)
    cum = torch.cumsum(ref, 0) - ref
    # a record's ops follow one another: its first is where owner starts
    cursor = pos[owner] + cum - cum[torch.searchsorted(owner, owner)]
    m = (op == 0) | (op == 7) | (op == 8)
    wrap = lambda x: _as_i32(x & 0xFFFFFFFF).int()  # noqa: E731
    return (tid[owner[m]].int(), wrap(cursor[m]), wrap(cursor[m] + ln[m]))


def _fold(fl, tid, nb, nm, ind, idv):
    """Each chunk's records in order, as scan_chunk_records folds them:
    (runs int64[n, RUN_WORDS], chunk words int64[chunks, CHUNK_WORDS])."""
    n = fl.numel()
    runs, words = [], []
    fln = fl.numpy()
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        f = fln[lo:hi]
        errs = np.flatnonzero(f & ERROR)
        stop = hi if not errs.size else lo + int(errs[0])
        err = 0 if not errs.size else int(errs[0]) + 1
        n_primary = int((fln[lo:min(stop + 1, hi)] & PRIMARY).astype(
            bool).sum())
        sel = lo + np.flatnonzero(fln[lo:stop] & COUNTED)
        t = tid.numpy()[sel]
        new = np.ones(sel.size, bool)
        new[1:] = t[1:] != t[:-1]
        bounds = np.append(np.flatnonzero(new), sel.size)
        nmv = nm.numpy()[sel]
        nm_missing = int((nmv < 0).sum())
        prim = (fln[sel] & PRIMARY).astype(bool)
        nons = (fln[sel] & NONSUPP).astype(bool)
        has = ((fln[sel] & HAS_IDV) != 0) & (nmv >= 0)
        iv = torch.from_numpy(idv.numpy()[sel])
        zero = torch.zeros((), dtype=torch.float64)
        ip = torch.where(torch.from_numpy(has & prim), iv, zero)
        inn = torch.where(torch.from_numpy(has & nons), iv, zero)
        for a, b in zip(bounds[:-1], bounds[1:]):
            s = slice(int(a), int(b))
            # the identity sums in record order from 0.0 (a sequential scan)
            sums = [float(torch.cumsum(x[s], 0)[-1]) for x in (ip, inn)]
            runs.append([int(t[a]), int(prim[s].sum()), int(nons[s].sum()),
                         int(b - a), int(np.where(nmv[s] >= 0, nmv[s],
                                                  0).sum()),
                         int(ind.numpy()[sel][s].sum()),
                         int(nb.numpy()[sel][s].sum()),
                         *np.array(sums, np.float64).view(np.int64)])
        sorted_ = int(not (t.size and (np.diff(t) < 0).any()))
        first = int(t[0]) if t.size else -1
        last = int(t[-1]) if t.size else -1
        words.append([n_primary, nm_missing, sorted_, first, last, err,
                      bounds.size - 1, 0])
    return (np.array(runs, np.int64).reshape(-1, RUN_WORDS),
            np.array(words, np.int64).reshape(-1, CHUNK_WORDS))


def _chain(d, start, end, n_ref):
    """Steps (a) and (b): (the record offsets, the stitch words)."""
    n_regions = -(-(end - start) // REGION)
    if not n_regions:
        return (np.zeros(0, np.int64),
                np.array([0, start, 0, STOP_END, 0, 0, 0, 0], np.int64))
    first, exit_, starts = _speculate(d, start, end, n_regions, n_ref)
    return _stitch(d, start, end, first, exit_, starts)


def bytes_read(data, start, end, n_ref, skip_mask, req_mask,
               read_filter=None):
    """The bytes that a scan of data[start:end) has to read, in whole
    SECTOR-byte sectors counted from data's first byte (the allocator
    aligns it): each record's fixed fields from block_size to l_seq, and
    of each record the flags let through its CIGAR and its aux tags up to
    NM (a tag's header and the value bytes the search looks at). The read
    name, the sequence and the qualities are not read. The least the
    kernels' work moves, from the plain version's chain."""
    d = data.cpu()
    off, _ = _chain(d, int(start), int(end), n_ref)
    spans = []
    _analyse(d, torch.from_numpy(off), int(n_ref), skip_mask, req_mask,
             read_filter, spans)
    lo = torch.cat([a.reshape(-1) for a, _ in spans])
    hi = torch.cat([b.reshape(-1) for _, b in spans])
    keep = hi > lo
    first, past = lo[keep] // SECTOR, (hi[keep] - 1) // SECTOR + 1
    mark = torch.zeros(d.numel() // SECTOR + 2, dtype=torch.int32)
    one = torch.ones(first.numel(), dtype=torch.int32)
    mark.index_add_(0, first, one).index_add_(0, past, -one)
    return int((torch.cumsum(mark, 0) > 0).sum()) * SECTOR


def bam_scan_reference(data, start, end, n_ref, skip_mask, req_mask,
                       read_filter=None):
    """Plain version of the kernels: the same speculate, stitch and
    records steps, as tensor code over all regions or records at once and
    a Python walk over the regions; the same SegmentScan."""
    d = data.cpu()
    start, end = int(start), int(end)
    off, stitch = _chain(d, start, end, n_ref)
    off = torch.from_numpy(off)
    fl, tid, nb, nm, ind, idv, cig = _analyse(d, off, int(n_ref), skip_mask,
                                              req_mask, read_filter)
    btid, bstart, bend = _emit(d, off, tid, cig)
    runs, chunks = _fold(fl, tid, nb, nm, ind, idv)
    return SegmentScan(btid.numpy(), bstart.numpy(), bend.numpy(), runs,
                       chunks, stitch, None,
                       d[int(stitch[1]):end].numpy().copy())
