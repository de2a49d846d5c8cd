"""Synthetic coordinate-sorted BGZF BAM for benchmarks and smoke runs.

The workload of the repository's bench.py: contigs of random bases,
reads that are exact slices of them (one SNP each, an NM tag, banded
qualities), single-block `<read_len>M` CIGARs, coordinate-sorted.
Neighbouring records share most of their sequence, which gives the
compression profile of real BAMs.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .io import bgzf


def write_sorted_bam(path, n_contigs=32, contig_len=1_000_000, coverage=20,
                     read_len=150, seed=0, names=None):
    """Write the BAM; returns (tids, starts, lengths) of its reads, all
    mapped, primary, mapq 60. `names` gives the contig names (default
    c0, c1, ...)."""
    rng = np.random.default_rng(seed)
    n_reads = n_contigs * contig_len * coverage // read_len
    tids = np.sort(rng.integers(0, n_contigs, n_reads)).astype(np.int32)
    starts = (rng.random(n_reads) * (contig_len - 1)).astype(np.int32)
    order = np.lexsort((starts, tids))
    tids, starts = tids[order], starts[order]
    if names is None:
        names = [f"c{i}" for i in range(n_contigs)]

    LNAME, LSEQ = 10, read_len
    seq_b = (LSEQ + 1) // 2
    rec_size = 4 + 32 + LNAME + 4 + seq_b + LSEQ + 4
    rec = np.zeros((n_reads, rec_size), dtype=np.uint8)

    def put_i32(col, vals):
        v = np.asarray(vals, dtype=np.int64)
        for k in range(4):
            rec[:, col + k] = (v >> (8 * k)) & 0xFF

    put_i32(0, rec_size - 4)            # block_size
    put_i32(4, tids)                    # refID
    put_i32(8, starts)                  # pos
    rec[:, 12] = LNAME
    rec[:, 13] = 60                     # mapq
    rec[:, 16] = 1                      # n_cigar
    put_i32(20, LSEQ)                   # l_seq
    put_i32(24, -1)                     # next_refID
    put_i32(28, -1)                     # next_pos
    rec[:, 36] = ord("r")
    idx = np.arange(n_reads, dtype=np.int64)
    for k in range(8):
        rec[:, 37 + k] = ord("0") + (idx // 10 ** (7 - k)) % 10
    put_i32(46, (read_len << 4) | 0)    # CIGAR: <read_len>M
    nyb_map = np.array([1, 2, 4, 8], np.uint8)  # A C G T
    contig_codes = rng.integers(0, 4, (n_contigs, contig_len + LSEQ),
                                dtype=np.uint8)
    span = np.arange(LSEQ, dtype=np.int32)[None, :]
    CH = 1 << 18
    for o in range(0, n_reads, CH):
        t, s = tids[o:o + CH], starts[o:o + CH]
        codes = contig_codes[t[:, None], s[:, None] + span]
        snp_at = rng.integers(0, LSEQ, t.size)
        codes[np.arange(t.size), snp_at] ^= \
            rng.integers(1, 4, t.size).astype(np.uint8)
        nyb = nyb_map[codes]
        rec[o:o + CH, 50:50 + seq_b] = (nyb[:, 0::2] << 4) | nyb[:, 1::2]
    rec[:, 50 + seq_b:50 + seq_b + LSEQ] = \
        (25 + (np.arange(LSEQ) * 7) % 12).astype(np.uint8)  # binned quals
    a0 = 50 + seq_b + LSEQ
    rec[:, a0] = ord("N")
    rec[:, a0 + 1] = ord("M")
    rec[:, a0 + 2] = ord("C")
    rec[:, a0 + 3] = rng.integers(0, 3, n_reads, dtype=np.uint8)

    hdr = bytearray(b"BAM\x01")
    text = b"".join(b"@SQ\tSN:%s\tLN:%d\n" % (n.encode(), contig_len)
                    for n in names)
    hdr += struct.pack("<i", len(text)) + text
    hdr += struct.pack("<i", n_contigs)
    for n in names:
        nb = n.encode() + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<I", contig_len)

    buf = rec.reshape(-1).tobytes()
    with open(path + ".tmp", "wb") as f:
        f.write(bgzf.compress_block(bytes(hdr), 1))
        step = 0xFF00
        for o in range(0, len(buf), step):
            f.write(bgzf.compress_block(buf[o:o + step], 1))
        f.write(bgzf.BGZF_EOF)
    os.replace(path + ".tmp", path)
    return tids, starts, np.full(n_contigs, contig_len, dtype=np.int64)
