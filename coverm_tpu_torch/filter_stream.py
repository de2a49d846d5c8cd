"""Streaming `coverm filter`: bounded-memory BAM rewrite.

The reference's filter subcommand round-trips BAMs with multi-GB
headers (test_cmdline.rs:4212-4369 builds 2.5/4.5 GB headers), which
loading the whole file cannot.  Here the header block is COPIED through
in chunks without ever materialising it, and records stream
segment-by-segment:

  - single-read thresholds (or no thresholds): every complete record in
    the current segment is filtered and written immediately — memory is
    bounded by the segment size;
  - pair thresholds: batches are cut at contig boundaries (mates of the
    pairs the reference considers are same-contig, filter.rs:180-183
    warns and skips cross-contig "proper" pairs), matching
    FilteredBamFileSource's batching guarantee.

Reference parity: filter.rs:86-234 emission semantics via
readfilter.apply_read_filter.
"""

from __future__ import annotations

import struct

import numpy as np

from .io import bgzf
from .io.bam import (BamStreamReader, TruncatedHeaderError,
                     concat_batches, record_bytes)
from .readfilter import apply_read_filter, reads_whole_records


class _HeaderCopier:
    """Incrementally parse-and-copy the BAM header block.

    feed() consumes buffer bytes, writes them to the output verbatim,
    and returns the number consumed; .done flips once the reference
    list has been fully copied.  State is O(1): the SAM text (possibly
    GBs of comments) is never held.
    """

    def __init__(self, writer):
        self._w = writer
        self._state = "magic"
        self._need = 8          # magic + l_text
        self._text_left = 0
        self._refs_left = 0
        self.n_ref = None
        self.done = False

    def feed(self, buf: bytes, start: int = 0) -> int:
        n = len(buf)
        p = start
        while not self.done:
            if self._state == "magic":
                if p + 8 > n:
                    break
                if bytes(buf[p:p + 4]) != b"BAM\x01":
                    from .io.bam import BamFormatError
                    raise BamFormatError("Not a BAM file (bad magic)")
                (l_text,) = struct.unpack_from("<I", buf, p + 4)
                self._w.write(buf[p:p + 8])
                p += 8
                self._text_left = l_text
                self._state = "text"
            elif self._state == "text":
                take = min(self._text_left, n - p)
                if take:
                    self._w.write(buf[p:p + take])
                    p += take
                    self._text_left -= take
                if self._text_left:
                    break
                self._state = "nref"
            elif self._state == "nref":
                if p + 4 > n:
                    break
                (n_ref,) = struct.unpack_from("<i", buf, p)
                self._w.write(buf[p:p + 4])
                p += 4
                self.n_ref = self._refs_left = n_ref
                self._state = "refs"
            else:  # refs
                if self._refs_left == 0:
                    self.done = True
                    break
                if p + 4 > n:
                    break
                (l_name,) = struct.unpack_from("<i", buf, p)
                entry = 4 + l_name + 4
                if p + entry > n:
                    break
                self._w.write(buf[p:p + entry])
                p += entry
                self._refs_left -= 1
                if self._refs_left == 0:
                    self.done = True
        return p


def stream_filter_bam(in_path: str, out_path: str, params, flag_filters,
                      inverse: bool = False, target_bytes: int = 1 << 28,
                      device=None):
    """Filter one BAM into another in bounded memory. Its records are
    inflated and parsed where io/bam.BamStreamReader puts them on
    `device` (device.resolve_device: None is the card), each once.

    Returns (n_kept, n_total)."""
    # anything that is not single-only runs the pair path (filter.rs:88)
    # and therefore needs same-contig mates inside one batch
    filtering_pairs = reads_whole_records(params, flag_filters)
    reader = BamStreamReader(in_path, target_bytes=target_bytes,
                             device=device)
    kept = total = 0
    with open(out_path, "wb") as f:
        w = bgzf.BgzfWriter(f)
        hc = _HeaderCopier(w)

        def header_at(buf, final):
            """The header copied through as it comes (io/bam's
            BamStreamReader.parsed); an empty stream has none."""
            start = hc.feed(buf)
            if hc.done:
                return start, hc.n_ref
            if final and len(buf):
                raise TruncatedHeaderError(
                    f"BAM header of {in_path} is truncated")
            return start, None

        def emit(batch):
            nonlocal kept, total
            if batch.n_records == 0:
                return
            keep, order = apply_read_filter(batch, params, flag_filters,
                                            filter_out=not inverse)
            total += batch.n_records
            kept += int(np.count_nonzero(keep))
            data = record_bytes(batch)
            if len(order) == 0:
                return
            # coalesce adjacent kept records into single writes
            starts = np.asarray(batch.rec_start)[order]
            ends = np.asarray(batch.rec_end)[order]
            brk = np.flatnonzero(starts[1:] != ends[:-1])
            run_s = np.concatenate(([0], brk + 1))
            run_e = np.concatenate((brk, [len(order) - 1]))
            for a, b in zip(run_s, run_e):
                w.write(data[starts[a]:ends[b]])

        # held: the parsed rows of the trailing open contig (pairs), emitted
        # when it closes
        held = []
        for batch, _tail, last in reader.parsed(header_at):
            if batch.n_records == 0:
                continue
            if not filtering_pairs:
                emit(batch)
                continue
            if last:
                held.append(batch)
                continue
            # hold back the trailing open contig so mate pairs never span
            # batches (contig-boundary cut)
            last_tid = int(batch.tid[-1])
            earlier = np.flatnonzero(batch.tid != last_tid)
            cut = int(earlier[-1]) + 1 if earlier.size else 0
            if cut == 0:
                if held and int(held[0].tid[0]) != last_tid:
                    emit(concat_batches(held))
                    held = []
                held.append(batch)
                continue
            emit(concat_batches(held + [batch.rows(0, cut)]))
            n = batch.n_records
            held = [batch.rows(cut, n)] if cut < n else []
        if held:
            emit(concat_batches(held))
        w.close()
    return kept, total
