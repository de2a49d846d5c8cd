"""Sharded ("deshard") reading: best-hit merge over reference shards
(shard_bam_reader.rs).

Reads are mapped against several reference shards; per read pair the
shard with the highest summed AS score wins (shard_bam_reader.rs:217-263)
and its two primary records are emitted with tids re-offset into the
concatenated header.  The reference breaks score ties *randomly*
(thread_rng, :255); this engine picks the first tied shard — a
deterministic, documented divergence.

Array formulation: each shard's name-sorted primary records line up
positionally (record set k = the k-th primary record of every shard), so
winner selection is one argmax over a (n_shards, n_pairs) score matrix
and the merged stream is a vectorised take + coordinate sort — the
single-host analogue of an all-reduce(max) over the shard axis
(SURVEY.md §2.3).

Above STREAM_THRESHOLD_BYTES (total shard size) the merge streams:
shards decode in lockstep chunks and the winners coordinate-sort
through the tid-bucketed external sorter, so memory is O(chunk x
shards + largest sort bucket) instead of O(all shards)
(stream_merge_shards).
"""

from __future__ import annotations

import os

import numpy as np

from .genome_exclusion import GenomeExclusion, NoExclusionGenomeFilter
from .io.bam import BamHeader, BamReader, RecordBatch, record_bytes


class ShardedBamSource:
    """Merged best-hit view over shard BAMs (read-name sorted, paired)."""

    def __init__(self, bam_paths, genome_exclusion: GenomeExclusion = None,
                 stoit_name=None, device=None):
        self.bam_paths = list(bam_paths)
        # where the streamed shards inflate and parse (io/bam's reader)
        self.device = device
        self.genome_exclusion = genome_exclusion or NoExclusionGenomeFilter()
        if stoit_name is None:
            stems = [os.path.basename(p)[:-4] if p.endswith(".bam")
                     else os.path.basename(p) for p in bam_paths]
            stoit_name = "|".join(stems)
        self.stoit_name = stoit_name

    @property
    def name(self):
        return self.stoit_name

    def read(self):
        from .modes import STREAM_THRESHOLD_BYTES
        total = sum(os.path.getsize(p) for p in self.bam_paths)
        if total >= STREAM_THRESHOLD_BYTES:
            return stream_merge_shards(self.bam_paths, self.genome_exclusion,
                                       device=self.device)
        shards = [BamReader(p) for p in self.bam_paths]
        return merge_shards([s.header for s in shards],
                            [s.batch for s in shards], self.genome_exclusion)

    def finish(self):
        pass


def stream_merge_shards(bam_paths, genome_exclusion=None, device=None):
    """Bounded-memory deshard: shards stream in lockstep, winners are
    chosen chunk by chunk, and the merged records coordinate-sort
    through the tid-bucketed external sorter (RecordSpillSorter).

    Each shard's primary records line up positionally (same read set,
    name-sorted), so a chunk of 2k records from every shard covers the
    same k pairs; memory is O(chunk x shards + largest sort bucket).
    Emits exactly the records the in-memory merge picks, in the same
    final order (the external sorter's (tid, pos, input-order) key
    equals the in-memory path's stable lexsort).
    """
    import struct

    from .io.bam import BamStreamReader
    from .mapping.pipeline import RecordSpillSorter

    genome_exclusion = genome_exclusion or NoExclusionGenomeFilter()
    readers = [BamStreamReader(p, cut_contigs=False, device=device).read()
               for p in bam_paths]
    headers = [h for h, _gen in readers]
    gens = [gen for _h, gen in readers]
    tid_offsets = np.concatenate(
        ([0], np.cumsum([h.n_ref for h in headers])))[:-1]
    merged_names = [n for h in headers for n in h.target_names]
    merged_lens = np.concatenate([h.target_lens for h in headers])
    merged_header = BamHeader(text="", target_names=merged_names,
                              target_lens=merged_lens, raw=b"")
    n_shards = len(gens)
    excluding = not isinstance(genome_exclusion, NoExclusionGenomeFilter)

    def batches():
        sorter = RecordSpillSorter(len(merged_names))
        pending = [[] for _ in range(n_shards)]   # primary-only batches
        avail = [0] * n_shards
        done = [False] * n_shards

        def refill(s):
            while not done[s] and avail[s] < 2:
                nxt = next(gens[s], None)
                if nxt is None:
                    done[s] = True
                    return
                keep = nxt.is_primary()
                if not np.all((nxt.flag[keep] & 0x1) != 0):
                    raise SystemExit(
                        "This code can only handle paired-end input (at "
                        "the moment), sorry.")
                b = nxt.select(keep)
                if b.n_records:
                    pending[s].append(b)
                    avail[s] += b.n_records

        def take(s, k):
            """Pop k primary records from shard s as column arrays +
            per-record byte views."""
            cols = {"tid": [], "pos": [], "flag": [], "as_score": [],
                    "qname_hash": []}
            recs = []
            left = k
            while left:
                b = pending[s][0]
                m = min(left, b.n_records)
                for f in cols:
                    cols[f].append(getattr(b, f)[:m])
                data = record_bytes(b)
                for i in range(m):
                    recs.append(bytes(
                        data[int(b.rec_start[i]):int(b.rec_end[i])]))
                rest = b.select(np.arange(b.n_records) >= m)
                if rest.n_records:
                    pending[s][0] = rest
                else:
                    pending[s].pop(0)
                avail[s] -= m
                left -= m
            return {f: np.concatenate(v) for f, v in cols.items()}, recs

        CHUNK_PAIRS = 8192
        while True:
            for s in range(n_shards):
                refill(s)
            if all(done) and all(a == 0 for a in avail):
                break
            if any(done[s] and avail[s] == 0 for s in range(n_shards)):
                raise SystemExit(
                    "Unexpectedly one BAM file input finished while "
                    "another had further reads")
            # keep pulling until every shard holds >= one chunk or is done
            while any(not done[s] and avail[s] < 2 * CHUNK_PAIRS
                      for s in range(n_shards)):
                for s in range(n_shards):
                    if not done[s] and avail[s] < 2 * CHUNK_PAIRS:
                        nxt = next(gens[s], None)
                        if nxt is None:
                            done[s] = True
                            continue
                        keep = nxt.is_primary()
                        if not np.all((nxt.flag[keep] & 0x1) != 0):
                            raise SystemExit(
                                "This code can only handle paired-end "
                                "input (at the moment), sorry.")
                        b = nxt.select(keep)
                        if b.n_records:
                            pending[s].append(b)
                            avail[s] += b.n_records
            k = min(min(avail), 2 * CHUNK_PAIRS)
            k -= k % 2
            if k == 0:
                if all(done):
                    if any(avail):
                        raise SystemExit(
                            "Unexpectedly was able to read a first read "
                            "set, but not a second. Hmm.")
                    break
                continue
            chunks = [take(s, k) for s in range(n_shards)]
            for c in chunks[1:]:
                if not np.array_equal(c[0]["qname_hash"],
                                      chunks[0][0]["qname_hash"]):
                    raise SystemExit(
                        "BAM files do not appear to be properly sorted "
                        "by read name.")
            n_pairs = k // 2
            scores = np.zeros((n_shards, n_pairs), dtype=np.int64)
            allowed = np.ones((n_shards, n_pairs), dtype=bool)
            for s, (cols, _recs) in enumerate(chunks):
                unmapped = (cols["flag"] & 0x4) != 0
                as_ = np.where(unmapped, 0, cols["as_score"])
                if np.any((~unmapped)
                          & (cols["as_score"] == np.iinfo(np.int64).min)):
                    raise SystemExit(
                        "Mapping record encountered that does not have an "
                        "'AS' auxiliary tag in the SAM/BAM format. This is "
                        "required for ranking pairs of alignments.")
                scores[s] = as_[0::2] + as_[1::2]
                if excluding:
                    names = headers[s].target_names
                    first_tids = cols["tid"][0::2]
                    excl = np.array([
                        t >= 0 and genome_exclusion.is_excluded(names[t])
                        for t in first_tids.tolist()])
                    allowed[s] = ~excl
            masked = np.where(allowed, scores, np.iinfo(np.int64).min)
            if np.any(~allowed.any(axis=0)):
                raise SystemExit(
                    "CoverM cannot currently deal with reads that only "
                    "map to excluded genomes")
            winner = np.argmax(masked, axis=0)  # ties -> lowest shard

            for p in range(n_pairs):
                s = int(winner[p])
                off = int(tid_offsets[s])
                cols, recs = chunks[s]
                for i in (2 * p, 2 * p + 1):
                    rec = bytearray(recs[i])
                    tid = int(cols["tid"][i])
                    new_tid = tid + off  # offset applies even to tid -1,
                    # matching the in-memory merge / shard_bam_reader.rs
                    struct.pack_into("<i", rec, 4, new_tid)
                    (mtid,) = struct.unpack_from("<i", rec, 24)
                    struct.pack_into("<i", rec, 24, mtid + off)
                    sorter.add(new_tid, rec)
        yield from sorter.sorted_batches()

    return merged_header, batches()


def merge_shards(headers, raw_batches, genome_exclusion=None):
    """Best-hit merge of name-aligned shard batches -> (header, batch)."""
    genome_exclusion = genome_exclusion or NoExclusionGenomeFilter()
    # concatenated header with tid offsets (shard_bam_reader.rs:313-336)
    tid_offsets = np.concatenate(
        ([0], np.cumsum([h.n_ref for h in headers])))[:-1]
    merged_names = [n for h in headers for n in h.target_names]
    merged_lens = np.concatenate([h.target_lens for h in headers])
    merged_header = BamHeader(
        text="", target_names=merged_names, target_lens=merged_lens,
        raw=b"")

    prim = []
    for b in raw_batches:
        keep = b.is_primary()
        if not np.all((b.flag[keep] & 0x1) != 0):
            raise SystemExit(
                "This code can only handle paired-end input (at the "
                "moment), sorry.")
        prim.append(b.select(keep))

    n = prim[0].n_records
    for s_i, p in enumerate(prim):
        if p.n_records != n:
            raise SystemExit(
                "Unexpectedly one BAM file input finished while another "
                "had further reads")
    # name-sorted shards must agree on read order
    for p in prim[1:]:
        if not np.array_equal(p.qname_hash, prim[0].qname_hash):
            raise SystemExit(
                "BAM files do not appear to be properly sorted by read "
                "name.")
    if n % 2 != 0:
        raise SystemExit(
            "Unexpectedly was able to read a first read set, but not a "
            "second. Hmm.")
    n_pairs = n // 2

    # pair score per shard: AS of each mapped mate
    scores = np.zeros((len(prim), n_pairs), dtype=np.int64)
    allowed = np.ones((len(prim), n_pairs), dtype=bool)
    for s_i, p in enumerate(prim):
        as_ = np.where(p.is_unmapped(), 0, p.as_score)
        if np.any((~p.is_unmapped()) & (p.as_score == np.iinfo(np.int64).min)):
            raise SystemExit(
                "Mapping record encountered that does not have an 'AS' "
                "auxiliary tag in the SAM/BAM format. This is required "
                "for ranking pairs of alignments.")
        scores[s_i] = as_[0::2] + as_[1::2]
        first_tids = p.tid[0::2]
        if not isinstance(genome_exclusion, NoExclusionGenomeFilter):
            names = headers[s_i].target_names
            excl = np.array([
                t >= 0 and genome_exclusion.is_excluded(names[t])
                for t in first_tids.tolist()])
            allowed[s_i] = ~excl

    masked = np.where(allowed, scores, np.iinfo(np.int64).min)
    if np.any(~allowed.any(axis=0)):
        raise SystemExit(
            "CoverM cannot currently deal with reads that only map to "
            "excluded genomes")
    # deterministic tie-break: lowest shard index among the max scores
    winner = np.argmax(masked, axis=0)

    # gather both mates of each pair from the winning shard
    fields = ("tid", "pos", "flag", "mapq", "nm", "as_score", "seq_len",
              "aligned_cov", "aligned_single", "aligned_pair", "indels",
              "read_end", "qname_hash")
    win_rec = np.repeat(winner, 2)
    out = {}
    for f in fields:
        stacked = np.stack([getattr(p, f) for p in prim])
        out[f] = stacked[win_rec, np.arange(n)]
    # re-offset tids into the merged header (matching the reference,
    # the offset applies even to tid == -1 records)
    off = tid_offsets[win_rec]
    out["tid"] = (out["tid"] + off).astype(np.int32)

    # raw record bytes: concatenate shard datas, rebase offsets
    data_offsets = np.concatenate(
        ([0], np.cumsum([record_bytes(p).size for p in prim])))[:-1]
    data = b"".join(record_bytes(p).tobytes() for p in prim)
    rs = np.stack([p.rec_start for p in prim])
    re_ = np.stack([p.rec_end for p in prim])
    rec_start = rs[win_rec, np.arange(n)] + data_offsets[win_rec]
    rec_end = re_[win_rec, np.arange(n)] + data_offsets[win_rec]

    # blocks from the winning shard's records
    all_blocks = []
    for s_i, p in enumerate(prim):
        sel = winner[p.block_read // 2] == s_i
        all_blocks.append((p.block_read[sel], p.block_start[sel],
                           p.block_end[sel], s_i))
    block_read = np.concatenate([b[0] for b in all_blocks])
    block_start = np.concatenate([b[1] for b in all_blocks])
    block_end = np.concatenate([b[2] for b in all_blocks])

    batch = RecordBatch(
        n_records=n, tid=out["tid"], pos=out["pos"], flag=out["flag"],
        mapq=out["mapq"], nm=out["nm"], as_score=out["as_score"],
        seq_len=out["seq_len"], aligned_cov=out["aligned_cov"],
        aligned_single=out["aligned_single"],
        aligned_pair=out["aligned_pair"], indels=out["indels"],
        read_end=out["read_end"], qname_hash=out["qname_hash"],
        rec_start=rec_start, rec_end=rec_end,
        block_read=block_read.astype(np.int32),
        block_start=block_start, block_end=block_end, data=data)

    from .mapping.pipeline import sort_batch
    return merged_header, sort_batch(batch)


class ShardedMappingSource:
    """`--sharded` from raw reads: map one read set against EACH
    reference, align shard outputs by read name, best-hit merge
    (shard_bam_reader.rs:562-695, without the samtools sort -n stage —
    the name alignment is an in-engine lexsort)."""

    def __init__(self, mapping_program, indexes, jobs, stoit_name,
                 genome_exclusion: GenomeExclusion = None):
        self.mapping_program = mapping_program
        self.indexes = list(indexes)
        self.jobs = list(jobs)
        self.stoit_name = stoit_name
        self.genome_exclusion = genome_exclusion or NoExclusionGenomeFilter()
        self.num_primary_override = None

    @property
    def name(self):
        return self.stoit_name

    def read(self):
        from .mapping.pipeline import MappedReadsSource

        headers, batches = [], []
        for index, job in zip(self.indexes, self.jobs):
            src = MappedReadsSource(self.mapping_program, index, job,
                                    self.stoit_name, sort_mode="name")
            header, batch = src.read()
            headers.append(header)
            batches.append(batch)
        return merge_shards(headers, batches, self.genome_exclusion)

    def finish(self):
        for index in self.indexes:
            index.cleanup()
