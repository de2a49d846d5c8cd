"""Synthetic coordinate-sorted BAM and CRAM for benchmarks and smoke runs.

The workload of the repository's bench.py: contigs of random bases,
reads that are exact slices of them (one SNP each, an NM tag, banded
qualities), single-block `<read_len>M` CIGARs, coordinate-sorted.
Neighbouring records share most of their sequence, which gives the
compression profile of real BAMs. `write_sorted_bam` writes them as a
BGZF BAM, `write_cram_twin` the very same alignments as a CRAM 3.0 file.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

from .io import bgzf

_CHUNK = 1 << 18


@dataclass
class SynthReads:
    """The reads of one workload: coordinate-sorted tids and 0-based
    starts, the contigs' 2-bit bases, each read's SNP (offset in the read
    and the xor applied to its base) and its NM value."""

    tids: np.ndarray
    starts: np.ndarray
    contig_codes: np.ndarray
    snp_at: np.ndarray
    snp_xor: np.ndarray
    nm: np.ndarray
    contig_len: int
    read_len: int

    @property
    def lengths(self):
        return np.full(self.contig_codes.shape[0], self.contig_len,
                       dtype=np.int64)


def synth_reads(n_contigs=32, contig_len=1_000_000, coverage=20,
                read_len=150, seed=0, nm_hi=3) -> SynthReads:
    """Draw the workload's reads from `seed`, always in the same order, so
    that the BAM and its CRAM twin hold the same alignments; NM is drawn
    from 0..nm_hi - 1."""
    rng = np.random.default_rng(seed)
    n_reads = n_contigs * contig_len * coverage // read_len
    tids = np.sort(rng.integers(0, n_contigs, n_reads)).astype(np.int32)
    starts = (rng.random(n_reads) * (contig_len - 1)).astype(np.int32)
    order = np.lexsort((starts, tids))
    tids, starts = tids[order], starts[order]
    contig_codes = rng.integers(0, 4, (n_contigs, contig_len + read_len),
                                dtype=np.uint8)
    snp_at = np.empty(n_reads, np.int64)
    snp_xor = np.empty(n_reads, np.uint8)
    for o in range(0, n_reads, _CHUNK):
        m = min(_CHUNK, n_reads - o)
        snp_at[o:o + m] = rng.integers(0, read_len, m)
        snp_xor[o:o + m] = rng.integers(1, 4, m).astype(np.uint8)
    nm = rng.integers(0, nm_hi, n_reads, dtype=np.uint8)
    return SynthReads(tids, starts, contig_codes, snp_at, snp_xor, nm,
                      contig_len, read_len)


def _names_of(n_contigs, names):
    return [f"c{i}" for i in range(n_contigs)] if names is None else names


def write_sorted_bam(path, n_contigs=32, contig_len=1_000_000, coverage=20,
                     read_len=150, seed=0, names=None, nm_hi=3):
    """Write the BAM; returns (tids, starts, lengths) of its reads, all
    mapped, primary, mapq 60. `names` gives the contig names (default
    c0, c1, ...); NM is drawn from 0..nm_hi - 1."""
    reads = synth_reads(n_contigs, contig_len, coverage, read_len, seed,
                        nm_hi)
    tids, starts = reads.tids, reads.starts
    n_reads = tids.size
    names = _names_of(n_contigs, names)

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
    span = np.arange(LSEQ, dtype=np.int32)[None, :]
    CH = _CHUNK
    for o in range(0, n_reads, CH):
        t, s = tids[o:o + CH], starts[o:o + CH]
        codes = reads.contig_codes[t[:, None], s[:, None] + span]
        codes[np.arange(t.size), reads.snp_at[o:o + CH]] ^= \
            reads.snp_xor[o:o + CH]
        nyb = nyb_map[codes]
        rec[o:o + CH, 50:50 + seq_b] = (nyb[:, 0::2] << 4) | nyb[:, 1::2]
    rec[:, 50 + seq_b:50 + seq_b + LSEQ] = \
        (25 + (np.arange(LSEQ) * 7) % 12).astype(np.uint8)  # binned quals
    a0 = 50 + seq_b + LSEQ
    rec[:, a0] = ord("N")
    rec[:, a0 + 1] = ord("M")
    rec[:, a0 + 2] = ord("C")
    rec[:, a0 + 3] = reads.nm

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
    return tids, starts, reads.lengths


def _itf8_col(v):
    """Vectorised ITF8 column encode (values < 2^21)."""
    v = np.asarray(v, np.int64)
    if v.size and (v.min() < 0 or v.max() >= 1 << 21):
        raise ValueError("ITF8 column value out of the 3-byte range")
    nb = np.where(v < 0x80, 1, np.where(v < 0x4000, 2, 3))
    off = np.cumsum(nb) - nb
    out = np.zeros(int(nb.sum()), np.uint8)
    m1 = nb == 1
    out[off[m1]] = v[m1]
    m2 = nb == 2
    out[off[m2]] = 0x80 | (v[m2] >> 8)
    out[off[m2] + 1] = v[m2] & 0xFF
    m3 = nb == 3
    out[off[m3]] = 0xC0 | (v[m3] >> 16)
    out[off[m3] + 1] = (v[m3] >> 8) & 0xFF
    out[off[m3] + 2] = v[m3] & 0xFF
    return out.tobytes()


def write_cram_twin(path, n_contigs=32, contig_len=1_000_000, coverage=20,
                    read_len=150, seed=0, names=None, per_slice=10_000):
    """Write the CRAM 3.0 twin of write_sorted_bam's BAM for the same
    arguments: the same reads (tid, position, `<read_len>M`, flags 0,
    MAPQ 60, the NM value, the name, the qualities), written as htslib
    writes them by default: RR=1 reference-coded bases with no embedded
    reference (the SNP is one substitution feature), NM:c tags, detached
    mate information, single-reference slices of `per_slice` records, one
    slice a container. Streams are built with numpy and gzip-compressed.
    Returns (tids, starts, lengths) like write_sorted_bam."""
    from .io.cram import (CRAM_EOF, CRAM_MAGIC, CT_COMP_HEADER, CT_EXTERNAL,
                          CT_FILE_HEADER, CT_SLICE_HEADER, M_GZIP, M_RAW,
                          build_compression_header, build_slice_header,
                          byte_array_len_encoding, byte_array_stop_encoding,
                          ext_encoding, huffman_const_encoding, write_block,
                          write_container)

    reads = synth_reads(n_contigs, contig_len, coverage, read_len, seed)
    names = _names_of(n_contigs, names)
    tids = reads.tids.astype(np.int64)
    starts = reads.starts.astype(np.int64) + 1   # 1-based
    n_reads = tids.size

    IDS = {"AP": 5, "RN": 6, "FP": 13, "BS": 27, "QS": 25, "NMV": 40}
    senc = {
        "BF": huffman_const_encoding(0),
        "CF": huffman_const_encoding(3),     # QS stored | detached
        "RL": huffman_const_encoding(read_len),
        "AP": ext_encoding(IDS["AP"]),
        "RG": huffman_const_encoding(-1),
        "RN": byte_array_stop_encoding(0, IDS["RN"]),
        "MF": huffman_const_encoding(0),
        "NS": huffman_const_encoding(-1),
        "NP": huffman_const_encoding(0),
        "TS": huffman_const_encoding(0),
        "TL": huffman_const_encoding(0),
        "FN": huffman_const_encoding(1),     # one substitution per read
        "FC": huffman_const_encoding(ord("X")),
        "FP": ext_encoding(IDS["FP"]),
        "BS": ext_encoding(IDS["BS"]),
        "MQ": huffman_const_encoding(60),
        "QS": ext_encoding(IDS["QS"]),
    }
    tenc = {("NM", "c"): byte_array_len_encoding(
        huffman_const_encoding(1), ext_encoding(IDS["NMV"]))}
    comp_data = build_compression_header(
        senc, tenc, [[("NM", "c")]], rn_preserved=True, ap_delta=True,
        ref_required=True)

    qrow = (25 + (np.arange(read_len) * 7) % 12).astype(np.uint8)
    idx_all = np.arange(n_reads, dtype=np.int64)
    name_bytes = np.empty((n_reads, 10), np.uint8)   # r + 8 digits + stop
    name_bytes[:, 0] = ord("r")
    for k in range(8):
        name_bytes[:, 1 + k] = ord("0") + (idx_all // 10 ** (7 - k)) % 10
    name_bytes[:, 9] = 0
    fp = reads.snp_at + 1                            # 1-based in the read
    bs = reads.snp_xor - 1                           # substitution code

    bounds = np.searchsorted(tids, np.arange(n_contigs + 1))
    with open(path + ".tmp", "wb") as out:
        out.write(CRAM_MAGIC + bytes([3, 0])
                  + b"coverm-tpu".ljust(20, b"\x00"))
        text = b"".join(b"@SQ\tSN:%s\tLN:%d\n" % (n.encode(), contig_len)
                        for n in names)
        hdr_payload = struct.pack("<i", len(text)) + text
        out.write(write_container(-1, 0, 0, 0, 0, 0, [
            write_block(M_RAW, CT_FILE_HEADER, 0, hdr_payload)]))
        counter = 0
        for c in range(n_contigs):
            lo, hi = int(bounds[c]), int(bounds[c + 1])
            for s0 in range(lo, hi, per_slice):
                s1 = min(s0 + per_slice, hi)
                n = s1 - s0
                st = starts[s0:s1]
                ap = np.zeros(n, np.int64)
                np.subtract(st[1:], st[:-1], out=ap[1:])
                streams = [
                    (IDS["AP"], _itf8_col(ap)),
                    (IDS["RN"], name_bytes[s0:s1].tobytes()),
                    (IDS["FP"], _itf8_col(fp[s0:s1])),
                    (IDS["BS"], bs[s0:s1].tobytes()),
                    (IDS["NMV"], reads.nm[s0:s1].tobytes()),
                    (IDS["QS"], np.broadcast_to(
                        qrow, (n, read_len)).tobytes()),
                ]
                blocks = [write_block(M_GZIP, CT_COMP_HEADER, 0, comp_data)]
                sl_start = int(st[0])
                sl_span = int(st[-1]) + read_len - sl_start
                sh = build_slice_header(c, sl_start, sl_span, n, counter,
                                        1 + len(streams),
                                        [cid for cid, _ in streams])
                blocks.append(write_block(M_RAW, CT_SLICE_HEADER, 0, sh))
                blocks.append(write_block(M_RAW, 5, 0, b""))  # empty core
                for cid, data in streams:
                    blocks.append(write_block(M_GZIP, CT_EXTERNAL, cid, data))
                out.write(write_container(c, sl_start, sl_span, n, counter,
                                          n * read_len, blocks))
                counter += n
        out.write(CRAM_EOF)
    os.replace(path + ".tmp", path)
    return reads.tids, reads.starts, reads.lengths


def write_gene_gff(path, names, contig_len, gene_len=900, step=1000,
                   stretch_every=10, stretch=200, n_absent=3):
    """A GFF3 of genes on every contig: one of `gene_len` bp every `step`
    bp, every `stretch_every`-th stretched by `stretch` bp so that it
    overlaps the next, and `n_absent` genes on a contig the header does
    not name. Returns the number of genes on named contigs."""
    n = 0
    with open(path, "w") as f:
        f.write("##gff-version 3\n")
        for name in names:
            for s in range(0, contig_len - gene_len + 1, step):
                n += 1
                e = s + gene_len + (stretch if n % stretch_every == 0 else 0)
                f.write(f"{name}\tsynth\tgene\t{s + 1}\t{min(e, contig_len)}"
                        f"\t.\t+\t.\tID=gene{n}\n")
        for j in range(n_absent):
            f.write(f"absent{j}\tsynth\tgene\t1\t{gene_len}\t.\t+\t.\t"
                    f"ID=absent{j}\n")
    return n


def write_shard_bams(paths, n_contigs=8, contig_len=100_000, coverage=20,
                     read_len=150, seed=2):
    """Write one read-name-sorted, paired BAM per path in `paths`, each
    the mapping of one read set against its own reference shard (contigs
    `s<k>g<i % 2>~c<i>`, n_contigs split evenly). Every pair comes from
    one home contig, where both mates map with AS = read_len - NM; in
    each other shard it maps elsewhere with a lower AS one time in
    three, and is unmapped otherwise. Returns the number of pairs."""
    from .io.sam import sam_text_to_bam_data

    rng = np.random.default_rng(seed)
    n_shards = len(paths)
    per = n_contigs // n_shards
    n_pairs = n_contigs * contig_len * coverage // (2 * read_len)
    home = rng.integers(0, n_contigs, n_pairs)
    p1 = rng.integers(1, contig_len - 3 * read_len, n_pairs)
    p2 = p1 + rng.integers(0, 2 * read_len, n_pairs)
    nm = rng.integers(0, 4, (n_pairs, 2))
    cross = rng.random((n_shards, n_pairs)) < 1 / 3
    other = rng.integers(0, per, (n_shards, n_pairs))
    seq = "A" * read_len
    for k, path in enumerate(paths):
        names = [f"s{k}g{i % 2}~c{i}" for i in range(per)]
        sam = [f"@SQ\tSN:{n}\tLN:{contig_len}" for n in names]
        for j in range(n_pairs):
            q = f"q{j:08d}"
            if home[j] // per == k:
                t, pen = names[home[j] % per], 0
            elif cross[k, j]:
                t, pen = names[other[k, j]], 5
            else:
                sam.append(f"{q}\t77\t*\t0\t0\t*\t*\t0\t0\t{seq}\t*")
                sam.append(f"{q}\t141\t*\t0\t0\t*\t*\t0\t0\t{seq}\t*")
                continue
            a, b = int(p1[j]), int(p2[j])
            n1, n2 = int(nm[j, 0]) + pen, int(nm[j, 1]) + pen
            sam.append(f"{q}\t99\t{t}\t{a}\t60\t{read_len}M\t=\t{b}\t0\t"
                       f"{seq}\t*\tNM:i:{n1}\tAS:i:{read_len - n1}")
            sam.append(f"{q}\t147\t{t}\t{b}\t60\t{read_len}M\t=\t{a}\t0\t"
                       f"{seq}\t*\tNM:i:{n2}\tAS:i:{read_len - n2}")
        with open(path, "wb") as f:
            w = bgzf.BgzfWriter(f)
            w.write(sam_text_to_bam_data(iter(sam)))
            w.close()
    return n_pairs


def write_genome_fastas(directory, genomes, contig_len=100_000, seed=3,
                        copies=None):
    """One FASTA `<genome>.fna` per entry of `genomes` (name -> its contig
    names) in `directory`, of random bases drawn from `seed`. A genome
    named in `copies` (name -> source genome) holds the source's contigs,
    in order, with 0.5% of their bases changed, so that the two cluster
    together at the usual ANI thresholds. Returns the paths, in the order
    of `genomes`."""
    rng = np.random.default_rng(seed)
    copies = copies or {}
    bases = np.frombuffer(b"ACGT", np.uint8)
    seqs = {g: [rng.integers(0, 4, contig_len, dtype=np.uint8)
                for _ in names] for g, names in genomes.items()
            if g not in copies}
    for g, src in copies.items():
        seqs[g] = []
        for codes in seqs[src]:
            codes = codes.copy()
            hit = rng.random(codes.size) < 0.005
            codes[hit] = (codes[hit] + rng.integers(1, 4, int(hit.sum()),
                                                    dtype=np.uint8)) % 4
            seqs[g].append(codes)
    paths = []
    for g, names in genomes.items():
        path = os.path.join(directory, f"{g}.fna")
        with open(path, "wb") as f:
            for name, codes in zip(names, seqs[g]):
                f.write(b">%s\n%s\n" % (name.encode(), bases[codes].tobytes()))
        paths.append(path)
    return paths
