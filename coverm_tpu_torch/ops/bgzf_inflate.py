"""BGZF inflate on the card: a hand-written CUDA kernel and its plain version.

The kernel (csrc/bgzf_inflate.cu) decodes a batch of independent BGZF
blocks, one CTA a block (a decoder warp and a copy warp), straight from
pinned host memory into card memory (or pinned host memory); it is
compiled with nvcc for sm_90a into a shared library with a plain C
interface on first use (ops/cuda_build.py, with the port's other
kernels) and bound with ctypes.
It takes over the inflate of the fused BAM ingest from the host
(native/bamdecode.cpp, ct_ingest_scan); the JAX package has no kernel
for it.

`bgzf_inflate(comp, table, out, status, device)` inflates the blocks that
`block_table` describes. For a CUDA device comp, table and status are
pinned host tensors, which the kernel reaches through their mapped
addresses, and out is pinned too or in the card's own memory; the launch
is asynchronous on the device's current stream. For the CPU the plain
version, `bgzf_inflate_reference`, inflates each block with Python's
zlib. `SegmentInflater` runs the fused ingest's segments through it, each
into a slot in card memory where the record scan (ops/bam_scan.py) reads
it.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import cuda_build

SOURCE = cuda_build.SOURCES[1]  # csrc/bgzf_inflate.cu
MAX_BLOCK = 65536  # BGZF's largest ISIZE (SAM specification §4.1)
# the kernel's per-block status
OK, BAD_CODE, BAD_DIST, OVERRUN, SHORT = range(5)
PAD = 16  # readable bytes the kernel's 16-byte loads need past a payload
FAILED = "BGZF inflate failed inside the fused ingest"
# SegmentInflater's buffers: segment s + 1 inflates while s is read
N_BUFS = 2

# launches of the CUDA kernel (the plain version does not count)
bgzf_inflate_launches = 0

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(cuda_build.build(SOURCE))
            vp = ctypes.c_void_p
            lib.bgzf_inflate_launch.restype = ctypes.c_int
            lib.bgzf_inflate_launch.argtypes = [vp] * 4 + [
                ctypes.c_longlong, ctypes.c_int, vp]
            lib.bgzf_inflate_occupancy.restype = ctypes.c_int
            lib.bgzf_inflate_occupancy.argtypes = [ctypes.c_int]
            lib.bgzf_inflate_smem_bytes.restype = ctypes.c_int
            _lib = lib
    return _lib


def block_table(comp: np.ndarray, rel_off, csz, usz) -> np.ndarray:
    """int64[n, 4] rows (payload offset, payload length, output offset,
    output size) of BGZF blocks whose gzip members start at `rel_off` in
    `comp`, `csz` bytes long, inflating to `usz` bytes each: the payload
    follows the 12-byte header and its XLEN extra bytes and stops before
    the 8-byte trailer; the outputs follow one another from 0."""
    rel_off = np.asarray(rel_off, np.int64)
    xlen = (comp[rel_off + 10].astype(np.int64)
            | comp[rel_off + 11].astype(np.int64) << 8)
    table = np.empty((rel_off.size, 4), np.int64)
    table[:, 0] = rel_off + 12 + xlen
    table[:, 1] = np.asarray(csz, np.int64) - 20 - xlen
    table[:, 3] = usz
    np.cumsum(table[:, 3], out=table[:, 2])
    table[:, 2] -= table[:, 3]
    return table


def _check(comp, table, out, status, device):
    if comp.dtype != torch.uint8 or out.dtype != torch.uint8 \
            or comp.dim() != 1 or out.dim() != 1:
        raise ValueError("bgzf_inflate takes uint8[] comp and out")
    if table.dtype != torch.int64 or table.dim() != 2 \
            or table.shape[1] != 4:
        raise ValueError("bgzf_inflate takes an int64[n, 4] block table")
    if status.dtype != torch.int32 or status.shape != (table.shape[0],):
        raise ValueError("bgzf_inflate takes an int32[n] status")
    for t in (comp, table, out, status):
        if not t.is_contiguous():
            raise ValueError("bgzf_inflate takes contiguous tensors")
    for t in (comp, table, status):
        if t.device.type != "cpu":
            raise ValueError("bgzf_inflate takes comp, table and status in "
                             "host memory")
    if out.device.type != "cpu" and (
            out.device.type != device.type or device.index not in (
                None, out.device.index)):
        raise ValueError("bgzf_inflate takes out in host memory or on the "
                         "card that inflates")


def bgzf_inflate(comp, table, out, status, device):
    """Inflate the blocks of `table` (block_table's rows) from `comp` into
    `out`, a status a block into `status` (0: inflated).

    On a CUDA `device` the kernel does it, asynchronously on the device's
    current stream: comp, table and status must be pinned host tensors,
    comp 16-byte aligned and readable PAD bytes past its last payload, and
    out pinned too or on that card. On the CPU the plain version does
    it."""
    global bgzf_inflate_launches
    device = torch.device(device)
    _check(comp, table, out, status, device)
    if device.type == "cpu":
        return bgzf_inflate_reference(comp, table, out, status)
    if device.type != "cuda":
        raise ValueError(f"bgzf_inflate: unsupported device {device}")
    if not all(t.is_pinned() for t in (comp, table, status)) or \
            (out.device.type == "cpu" and not out.is_pinned()):
        raise ValueError("bgzf_inflate on the card takes pinned tensors")
    if comp.data_ptr() % 16:
        raise ValueError("bgzf_inflate: comp must be 16-byte aligned")
    n = table.shape[0]
    if n and int(table[:, 0].add(table[:, 1]).max()) + PAD > comp.numel():
        raise ValueError("bgzf_inflate: comp ends within PAD bytes of a "
                         "payload")
    if n and int(table[:, 2].add(table[:, 3]).max()) > out.numel():
        raise ValueError("bgzf_inflate: out is too small for the table")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    err = _load().bgzf_inflate_launch(comp.data_ptr(), table.data_ptr(),
                                      out.data_ptr(), status.data_ptr(), n,
                                      index, stream)
    if err != 0:
        step = ("setting the card", "mapping comp", "mapping the table",
                "mapping out", "mapping the status", "sizing shared memory",
                "the launch")[min(err // 1000, 7) - 1]
        raise RuntimeError(f"bgzf_inflate kernel failed on cuda:{index} at "
                           f"{step}: CUDA error {err % 1000}")
    with _count_lock:
        bgzf_inflate_launches += 1


def occupancy(device):
    """(shared bytes a CTA, CTAs an SM of the card) of the kernel, as the
    card's occupancy query gives them."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    lib = _load()
    ctas = lib.bgzf_inflate_occupancy(index)
    if ctas < 0:
        raise RuntimeError(f"bgzf_inflate occupancy query failed on "
                           f"cuda:{index}: step {-ctas // 1000}, CUDA error "
                           f"{-ctas % 1000}")
    return lib.bgzf_inflate_smem_bytes(), ctas


def bgzf_inflate_reference(comp, table, out, status):
    """Plain version of the kernel: each block through zlib, under the
    kernel's contract (a block inflates to exactly its size, at most
    MAX_BLOCK, and ends its DEFLATE stream)."""
    c, o, st = comp.numpy(), out.numpy(), status.numpy()
    for b, (p, n, at, size) in enumerate(table.tolist()):
        if n < 0 or not 0 <= size <= MAX_BLOCK:
            st[b] = OVERRUN
            continue
        d = zlib.decompressobj(-15)
        try:
            data = d.decompress(c[p:p + n].tobytes(), size + 1)
        except zlib.error:
            st[b] = BAD_CODE
            continue
        if len(data) > size:
            st[b] = OVERRUN
        elif not d.eof:
            st[b] = OVERRUN if len(data) == size else SHORT
        elif len(data) < size:
            st[b] = SHORT
        else:
            o[at:at + size] = np.frombuffer(data, np.uint8)
            st[b] = OK


class SegmentInflater:
    """Inflates the BGZF segments of a file on `device`, a segment ahead of
    their reader.

    `segments` are the (i, k) block ranges of the fused ingest's plan;
    `off`, `csz`, `usz` its block table. start(s) has a worker thread read
    segment s's compressed bytes from the file into a staging buffer (in
    pinned host memory on a card), so the reading overlaps the caller's
    work. A staging buffer is reused by segment s + N_BUFS, so segment s is
    taken before s + N_BUFS starts. Each buffer is allocated when its first
    segment starts.

    take(s, carry) inflates segment s into a slot of its own on the
    device, just after `carry` (bytes in host memory, or None), at offset
    `at` or later when the carry is longer, and returns (slot, the carry's
    start, the segment's end): the caller's to scan and let go. It raises
    ValueError when a block failed. On a CUDA device the kernel inflates,
    on a stream of its own (`stream`); on the CPU the plain version.

    It keeps its own timings: `kernel_ms` a segment taken (CUDA events),
    `stage_s` the worker's seconds reading the segments,
    `wait_s` the caller's seconds blocked in take()."""

    def __init__(self, path, off, csz, usz, segments, at, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.off, self.csz, self.usz = off, csz, usz
        self.segments = list(segments)
        self.at = int(at)
        cum = np.concatenate(([0], np.cumsum(usz)))
        ends = off + csz
        self._out_bytes = [int(cum[k] - cum[i]) for i, k in self.segments]
        self._caps = (
            max((int(ends[k - 1] - off[i]) for i, k in self.segments),
                default=0) + PAD,
            max((k - i for i, k in self.segments), default=0))
        self._bufs = {}      # slot -> (comp, table, status)
        self.tensor_bytes = []
        self.pinned_bytes = 0
        self.stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._pending = {}   # slot -> the worker's future of _start
        self._worker = ThreadPoolExecutor(1)
        self.kernel_ms = []  # per segment taken, by CUDA events
        self.stage_s = 0.0
        self.wait_s = 0.0
        self._fd = os.open(path, os.O_RDONLY)

    def _buffers(self, slot):
        bufs = self._bufs.get(slot)
        if bufs is None:
            comp_cap, blocks = self._caps

            def host(n, dtype):
                return torch.empty(n, dtype=dtype, pin_memory=self._cuda)
            bufs = self._bufs[slot] = (
                host(comp_cap, torch.uint8), host((blocks, 4), torch.int64),
                host(blocks, torch.int32))
            self.tensor_bytes += [t.nbytes for t in bufs]
            if self._cuda:
                self.pinned_bytes += sum(t.nbytes for t in bufs)
        return bufs

    def _start(self, s):
        """On the worker: stage segment s's compressed bytes and block
        table."""
        t0 = time.perf_counter()
        comp, table, _status = self._buffers(s % N_BUFS)
        i, k = self.segments[s]
        lo, hi = int(self.off[i]), int(self.off[k - 1] + self.csz[k - 1])
        view = memoryview(comp.numpy())[:hi - lo]
        got = 0
        while got < hi - lo:
            n = os.preadv(self._fd, [view[got:]], lo + got)
            if n <= 0:
                raise ValueError(FAILED)  # the file shrank under the plan
            got += n
        table[:k - i].numpy()[:] = block_table(
            comp.numpy(), self.off[i:k] - lo, self.csz[i:k], self.usz[i:k])
        self.stage_s += time.perf_counter() - t0

    def _launch(self, comp, table, out, status):
        if self.stream is None:
            bgzf_inflate(comp, table, out, status, self.device)
            return None
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        with torch.cuda.stream(self.stream):
            ev[0].record()
            bgzf_inflate(comp, table, out, status, self.device)
            ev[1].record()
        return ev

    def start(self, s):
        slot = s % N_BUFS
        if slot in self._pending:
            raise RuntimeError(f"segment {s}'s buffer is still in use")
        self._pending[slot] = self._worker.submit(self._start, s)

    def take(self, s, carry=None):
        slot = s % N_BUFS
        t0 = time.perf_counter()
        self._pending.pop(slot).result()
        i, k = self.segments[s]
        comp, table, status = self._bufs[slot]
        n = 0 if carry is None else len(carry)
        at = max(self.at, n)
        size = self._out_bytes[s]
        with self.on_stream():
            # never empty, even for a segment of empty blocks
            dest = torch.empty(at + max(size, 1), dtype=torch.uint8,
                               device=self.device)
            if n:
                dest[at - n:at].copy_(torch.as_tensor(carry),
                                      non_blocking=True)
        ev = self._launch(comp, table[:k - i], dest[at:], status[:k - i])
        if ev is not None:
            ev[1].synchronize()
            self.kernel_ms.append(ev[0].elapsed_time(ev[1]))
        self.wait_s += time.perf_counter() - t0
        if status[:k - i].numpy().any():
            raise ValueError(FAILED)
        return dest, at - n, at + size

    def on_stream(self):
        """The inflater's stream as the current one (nothing on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def close(self):
        """Wait for the worker and the card, then let the buffers and the
        file go."""
        for fut in self._pending.values():
            fut.exception()  # waits; a segment never taken raises nothing
        self._pending.clear()
        self._worker.shutdown()
        if self.stream is not None:
            self.stream.synchronize()
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
        self._bufs.clear()
