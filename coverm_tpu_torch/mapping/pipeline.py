"""Mapper subprocess pipeline (bam_generator.rs:374-925 re-imagined).

The reference shells out `mapper | samtools sort -l0 > fifo` and reads
the FIFO as BAM.  Here the mapper's SAM stdout is consumed directly and
INCREMENTALLY: records are encoded to BAM bytes as they arrive and
*sorted inside the engine* — removing the samtools dependency entirely,
exactly as planned in SURVEY.md §2.2.  Small samples sort with one
in-memory argsort; past SPILL_THRESHOLD_BYTES the stream spills to
tid-bucketed run files and memory stays O(largest bucket)
(SamStreamConsumer), the bounded-memory property the reference gets
from its sort pipe.  BAM caching (`make`, --bam-file-cache-directory)
writes reference-sorted BAMs through our own BGZF encoder, incrementally
on the spilled path.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

import numpy as np

from ..io import bgzf
from ..io.bam import parse_bam_data_raw
from ..io.sam import _bam_header_bytes, encode_sam_record
from .external import check_mapper
from .index import generate_concatenated_fasta_file, setup_mapping_index
from .params import MappingParameters, ReadFormat

# Encoded-record bytes held in RAM before the mapper stream spills to
# tid-bucketed run files (bounded-memory analogue of the reference's
# `mapper | samtools sort -l0 | fifo` pipe, bam_generator.rs:445-468).
SPILL_THRESHOLD_BYTES = int(os.environ.get(
    "COVERM_TPU_MAPPER_SPILL_BYTES", 512 * 1024 * 1024))


class RecordSpillSorter:
    """tid-bucketed external sort of raw BAM record bytes.

    ``add(tid, rec)`` routes each record (with its leading block_size
    u32) to a per-tid-range bucket file; ``sorted_batches()`` loads each
    bucket — whose tid range is disjoint from and ordered before the
    next bucket's (unmapped last) — sorts it by (tid, pos, input order)
    and yields contig-disjoint RecordBatches.  Memory is O(largest
    bucket + flush buffers).  The per-record input sequence number makes
    the total emitted order identical to a single stable in-memory
    lexsort over (tid, pos).
    """

    N_BUCKETS = 64
    FLUSH_BYTES = 1 << 20  # per-bucket; worst-case buffered = ~N_BUCKETS MB

    def __init__(self, n_ref: int, tmpdir=None):
        import tempfile
        self.n_ref = max(int(n_ref), 1)
        self.n_buckets = min(self.N_BUCKETS, self.n_ref) + 1  # + unmapped
        self._tmp = tempfile.TemporaryDirectory(prefix="coverm-tpu-sort-",
                                                dir=tmpdir)
        self._rec_f = [open(os.path.join(self._tmp.name, f"b{i}.rec"), "wb")
                       for i in range(self.n_buckets)]
        self._seq_f = [open(os.path.join(self._tmp.name, f"b{i}.seq"), "wb")
                       for i in range(self.n_buckets)]
        self._buf = [bytearray() for _ in range(self.n_buckets)]
        self._seqbuf = [[] for _ in range(self.n_buckets)]
        self._n = 0

    def bucket_of(self, tid: int) -> int:
        nb = self.n_buckets - 1
        return nb if tid < 0 else tid * nb // self.n_ref

    def add(self, tid: int, rec):
        b = self.bucket_of(tid)
        self._buf[b] += rec
        self._seqbuf[b].append(self._n)
        self._n += 1
        if len(self._buf[b]) >= self.FLUSH_BYTES:
            self._flush(b)

    def _flush(self, b):
        if self._buf[b]:
            self._rec_f[b].write(self._buf[b])
            self._buf[b] = bytearray()
        if self._seqbuf[b]:
            self._seq_f[b].write(
                np.asarray(self._seqbuf[b], dtype="<i8").tobytes())
            self._seqbuf[b] = []

    def sorted_batches(self):
        from ..io.bam import parse_records
        for b in range(self.n_buckets):
            self._flush(b)
            self._rec_f[b].close()
            self._seq_f[b].close()
        try:
            for b in range(self.n_buckets):
                rec_path = os.path.join(self._tmp.name, f"b{b}.rec")
                if os.path.getsize(rec_path) == 0:
                    continue
                data = np.fromfile(rec_path, dtype=np.uint8)
                seq = np.fromfile(
                    os.path.join(self._tmp.name, f"b{b}.seq"), dtype="<i8")
                batch, _ = parse_records(data, 0)
                assert batch.n_records == seq.size
                tid_key = np.where(batch.tid < 0, np.iinfo(np.int32).max,
                                   batch.tid)
                order = np.lexsort((seq, batch.pos, tid_key))
                yield reorder_batch(batch, order)
        finally:
            self._tmp.cleanup()


class SamStreamConsumer:
    """Bounded-memory consumer of a mapper's SAM stdout.

    Records encode to BAM bytes as they arrive.  Small samples stay in
    one in-memory buffer and finalize exactly like sam_text_to_bam_data.
    Past ``spill_bytes``, records are routed through a RecordSpillSorter
    and yielded as reference-sorted contig-disjoint RecordBatches with
    the emitted order IDENTICAL to the in-memory path's stable sort.
    """

    def __init__(self, lines_iter, spill_bytes=None, tmpdir=None):
        self._lines = lines_iter
        self.spill_bytes = (SPILL_THRESHOLD_BYTES if spill_bytes is None
                            else spill_bytes)
        self._tmpdir_base = tmpdir
        self.header_lines = []
        self.names = []
        self.lens = []
        self.name_to_tid = {}
        self.spilled = False
        self.header = None

    def _consume_header(self):
        """Read header lines; returns the first record's fields (or
        None) and materialises self.header."""
        from ..io.bam import _parse_header
        first = None
        for line in self._lines:
            if isinstance(line, bytes):
                line = line.decode()
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            if line.startswith("@"):
                self.header_lines.append(line)
                if line.startswith("@SQ"):
                    sn, ln = None, None
                    for f in line.split("\t")[1:]:
                        if f.startswith("SN:"):
                            sn = f[3:]
                        elif f.startswith("LN:"):
                            ln = int(f[3:])
                    if sn is not None and ln is not None:
                        self.name_to_tid[sn] = len(self.names)
                        self.names.append(sn)
                        self.lens.append(ln)
                continue
            first = line.split("\t")
            break
        self._header_raw = _bam_header_bytes(self.header_lines, self.names,
                                             self.lens)
        self.header, _ = _parse_header(self._header_raw)
        return first

    def _start_spill(self, records, tids, lengths):
        """Re-route the accumulated in-memory records into bucket files."""
        self.spilled = True
        self._sorter = RecordSpillSorter(len(self.names),
                                         tmpdir=self._tmpdir_base)
        mv = memoryview(records)
        off = 0
        for tid, ln in zip(tids, lengths):
            self._sorter.add(tid, mv[off:off + ln])
            off += ln

    def run(self):
        """Returns (header, payload): payload is an UNSORTED RecordBatch
        (in-memory path — caller applies its own sort, exactly as
        before) or a generator of reference-sorted contig-disjoint
        batches (spilled path)."""
        first = self._consume_header()
        records = bytearray()
        tids = []
        lengths = []
        n = 0

        def encode(fields):
            rec = encode_sam_record(fields, self.name_to_tid)
            return self.name_to_tid.get(fields[2], -1), rec

        if first is not None:
            def rows():
                yield first
                for line in self._lines:
                    if isinstance(line, bytes):
                        line = line.decode()
                    line = line.rstrip("\n").rstrip("\r")
                    if line:
                        yield line.split("\t")

            for fields in rows():
                tid, rec = encode(fields)
                if self.spilled:
                    self._sorter.add(tid, rec)
                else:
                    records += rec
                    tids.append(tid)
                    lengths.append(len(rec))
                    if len(records) >= self.spill_bytes:
                        self._start_spill(records, tids, lengths)
                        records = tids = lengths = None
                n += 1

        if not self.spilled:
            data = self._header_raw + bytes(records)
            return parse_bam_data_raw(data)
        return self.header, self._sorter.sorted_batches()


def build_mapper_invocation(mapping_program: str, read_format: ReadFormat,
                            threads: int, read1: str, index, read2=None,
                            mapping_options=None) -> str:
    """Mapper command string (bam_generator.rs:927-1040), without the
    samtools stages."""
    if mapping_program in ("bwa-mem", "bwa-mem2"):
        read_params1 = "-p" if read_format == ReadFormat.INTERLEAVED else ""
    elif mapping_program == "strobealign":
        read_params1 = ("--interleaved"
                        if read_format == ReadFormat.INTERLEAVED else "")
    elif mapping_program == "rammap-sr":
        read_params1 = "--frag no" if read_format == ReadFormat.SINGLE else ""
    else:
        read_params1 = ""

    if read_format == ReadFormat.COUPLED:
        read_params2 = f"'{read1}' '{read2}'"
    else:
        read_params2 = f"'{read1}'"

    if mapping_program == "bwa-mem":
        prog = "bwa mem"
    elif mapping_program == "bwa-mem2":
        prog = "bwa-mem2 mem"
    elif mapping_program == "strobealign":
        prog = "strobealign"
    elif mapping_program == "minibwa":
        prog = "minibwa map"
    elif mapping_program.startswith("rammap"):
        preset = {
            "rammap-sr": "-x sr ", "rammap-ont": "-x map-ont ",
            "rammap-pb": "-x map-pb ", "rammap-hifi": "-x map-hifi ",
            "rammap-lr-hq": "-x 'lr:hq' ", "rammap-no-preset": "",
        }[mapping_program]
        prog = f"rammap {preset}-a".replace("  ", " ")
    else:  # minimap2 family
        preset = {
            "minimap2-sr": "-x sr", "minimap2-ont": "-x map-ont",
            "minimap2-pb": "-x map-pb", "minimap2-hifi": "-x map-hifi",
            "minimap2-lr-hq": "-x 'lr:hq'", "minimap2-no-preset": "",
        }[mapping_program]
        split_prefix = tempfile.mktemp(prefix="coverm-tpu-minimap2-split")
        prog = f"minimap2 --split-prefix {split_prefix} -a {preset}".rstrip()

    opts = mapping_options or ""
    return (f"{prog} {opts} -t {threads} {read_params1} "
            f"{index.command_prefix()}'{index.index_path()}' {read_params2}")


def name_stoit(index_path: str, read1_path: str,
               include_reference_in_stoit_name: bool) -> str:
    """Stoit naming (bam_generator.rs:208-228)."""
    prefix = (os.path.basename(index_path) + "/"
              if include_reference_in_stoit_name else "")
    return prefix + os.path.basename(read1_path)


class MappedReadsSource:
    """Run a mapper, consume its SAM stdout, sort in-engine."""

    def __init__(self, mapping_program, index, job, stoit_name,
                 cached_bam_path=None, discard_unmapped=False,
                 sort_mode="coordinate"):
        self.mapping_program = mapping_program
        self.index = index
        self.job = job
        self.stoit_name = stoit_name
        self.cached_bam_path = cached_bam_path
        self.discard_unmapped = discard_unmapped
        self.sort_mode = sort_mode
        self.num_primary_override = None

    @property
    def name(self):
        return self.stoit_name

    def read(self):
        import threading

        check_mapper(self.mapping_program)
        cmd = build_mapper_invocation(
            self.mapping_program, self.job.read_format, self.job.threads,
            self.job.read1, self.index, self.job.read2,
            self.job.mapping_options)
        proc = subprocess.Popen(["bash", "-c", "set -o pipefail; " + cmd],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        # drain stderr concurrently: the mapper must never block on a
        # full stderr pipe while we consume stdout incrementally
        stderr_chunks = []
        t_err = threading.Thread(
            target=lambda: stderr_chunks.append(proc.stderr.read()),
            daemon=True)
        t_err.start()

        def complete():
            """Reap the mapper (bam_generator.rs:230-274 semantics)."""
            t_err.join()
            stderr = b"".join(stderr_chunks)
            rc = proc.wait()
            if rc != 0:
                raise RuntimeError(
                    f"Mapping command '{cmd}' failed with exit code {rc}; "
                    f"stderr: {stderr.decode(errors='replace')[-2000:]}")
            if (self.mapping_program.startswith("minimap2") and
                    b"query files have different number of records" in stderr):
                raise RuntimeError(
                    "The STDERR for the minimap2 command run for mapping "
                    "indicated a problem: read1 and read2 have different "
                    "numbers of records")

        # name-sort (deshard) consumes the whole record set at once; the
        # coordinate path streams with bounded memory past the spill
        # threshold
        consumer = SamStreamConsumer(
            iter(proc.stdout),
            spill_bytes=(None if self.sort_mode == "coordinate"
                         else 1 << 62))
        header, payload = consumer.run()
        from ..io.bam import RecordBatch
        if isinstance(payload, RecordBatch):
            complete()
            batch = (name_sort_batch(payload) if self.sort_mode == "name"
                     else sort_batch(payload))
            if self.cached_bam_path is not None:
                write_bam(self.cached_bam_path, header, batch,
                          discard_unmapped=self.discard_unmapped)
            return header, batch
        return header, self._stream_batches(header, payload, complete)

    def _stream_batches(self, header, batches, complete):
        """Pass sorted batches through, writing the BAM cache
        incrementally and reaping the mapper at end-of-stream."""
        writer = None
        if self.cached_bam_path is not None:
            f = open(self.cached_bam_path, "wb")
            writer = bgzf.BgzfWriter(f)
            writer.write(header.raw)
        try:
            for batch in batches:
                if writer is not None:
                    keep = np.ones(batch.n_records, dtype=bool)
                    if self.discard_unmapped:
                        keep &= ~batch.is_unmapped()
                    data = batch.data
                    for i in np.flatnonzero(keep):
                        writer.write(
                            data[batch.rec_start[i]:batch.rec_end[i]])
                yield batch
            complete()
        finally:
            if writer is not None:
                writer.close()
                f.close()

    def finish(self):
        self.index.cleanup()


def name_sort_batch(batch):
    """Read-name order (samtools sort -n analogue for desharding): group
    by qname hash, read1 before read2."""
    read2 = (batch.flag & 0x80) != 0
    order = np.lexsort((read2, batch.qname_hash))
    return reorder_batch(batch, order)


def sort_batch(batch):
    """Reference-order sort: unmapped (tid -1) last, then (tid, pos) —
    htslib coordinate-sort semantics."""
    tid_key = np.where(batch.tid < 0, np.iinfo(np.int32).max, batch.tid)
    order = np.lexsort((batch.pos, tid_key))
    return reorder_batch(batch, order)


def reorder_batch(batch, order):
    from ..io.bam import RecordBatch
    remap = np.empty(batch.n_records, dtype=np.int64)
    remap[order] = np.arange(order.size)
    bkeep = np.argsort(remap[batch.block_read], kind="stable")
    return RecordBatch(
        n_records=batch.n_records,
        tid=batch.tid[order], pos=batch.pos[order], flag=batch.flag[order],
        mapq=batch.mapq[order], nm=batch.nm[order],
        as_score=batch.as_score[order], seq_len=batch.seq_len[order],
        aligned_cov=batch.aligned_cov[order],
        aligned_single=batch.aligned_single[order],
        aligned_pair=batch.aligned_pair[order], indels=batch.indels[order],
        read_end=batch.read_end[order], qname_hash=batch.qname_hash[order],
        rec_start=batch.rec_start[order], rec_end=batch.rec_end[order],
        block_read=remap[batch.block_read[bkeep]].astype(np.int32),
        block_start=batch.block_start[bkeep],
        block_end=batch.block_end[bkeep],
        data=batch.data,
    )


def write_bam(path, header, batch, discard_unmapped=False, mask=None,
              order=None):
    """Write a BAM from raw record bytes through our BGZF encoder."""
    keep = np.ones(batch.n_records, dtype=bool) if mask is None else mask
    if discard_unmapped:
        keep = keep & ~batch.is_unmapped()
    idx = np.flatnonzero(keep) if order is None else order
    data = batch.data
    with open(path, "wb") as f:
        w = bgzf.BgzfWriter(f)
        w.write(header.raw)
        for i in idx:
            w.write(data[batch.rec_start[i]:batch.rec_end[i]])
        w.close()


def _resolve_references(args):
    """Resolve -r/--reference or genome FASTA files into mapping
    references; generates the concatenated reference when needed."""
    tempfiles = []
    if getattr(args, "reference", None):
        refs = list(args.reference)
    else:
        from ..commands import parse_list_of_genome_fasta_files
        genome_files = parse_list_of_genome_fasta_files(args)
        if not genome_files:
            raise SystemExit(
                "Need either a reference (-r), BAM files (-b) or genome "
                "FASTA files to continue")
        path = generate_concatenated_fasta_file(genome_files)
        tempfiles.append(path)
        refs = [path]
    return refs, tempfiles


def _cache_name_iter(args):
    """--cache-unfiltered-bam-files: explicit cache paths, CLI order
    single/-1/-coupled/--interleaved, consumed in job-emission order
    (build_cache_name_iter, coverm.rs:1942-1988)."""
    names = getattr(args, "cache_unfiltered_bam_files", None)
    if not names:
        return None
    n_single = len(getattr(args, "single", None) or [])
    n_read1 = len(getattr(args, "read1", None) or [])
    n_coupled = len(getattr(args, "coupled", None) or []) // 2
    n_inter = len(getattr(args, "interleaved", None) or [])
    expected = n_single + n_read1 + n_coupled + n_inter
    if len(names) != expected:
        raise SystemExit(
            f"--cache-unfiltered-bam-files specified {len(names)} names but "
            f"{expected} read sets were provided")
    i = n_single
    single = names[:n_single]
    read1 = names[i:i + n_read1]
    i += n_read1
    coupled = names[i:i + n_coupled]
    i += n_coupled
    inter = names[i:i + n_inter]

    def gen():
        yield from read1 + coupled + inter + single
        raise SystemExit("Not enough BAM file cache names specified")

    return gen()


def build_mapping_sources(args, filter_params, flag_filters):
    """get_streamed_bam_readers equivalent (coverm.rs:1788-1840)."""
    refs, tempfiles = _resolve_references(args)
    include_ref_in_name = bool(getattr(args, "reference", None)) and \
        len(tempfiles) == 0
    params = MappingParameters.generate_from_args(args, refs)

    cache_dir = getattr(args, "bam_file_cache_directory", None)
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
    cache_names = _cache_name_iter(args)

    sources = []
    for ref, jobs in params.references:
        index = setup_mapping_index(
            ref, args.mapper, threads=args.threads,
            reference_is_index=getattr(args, "minimap2_reference_is_index",
                                       False),
            strobealign_use_index=getattr(args, "strobealign_use_index",
                                          False),
            n_readsets=len(jobs))
        for job in jobs:
            cached = None
            if cache_names is not None:
                cached = next(cache_names)
            elif cache_dir:
                cached = os.path.join(
                    cache_dir,
                    os.path.basename(ref) + "." +
                    os.path.basename(job.read1) + ".bam")
            src = MappedReadsSource(
                args.mapper, index, job,
                name_stoit(index.index_path(), job.read1, include_ref_in_name),
                cached_bam_path=cached,
                discard_unmapped=getattr(args, "discard_unmapped", False))
            sources.append(src)

    if filter_params.doing_filtering():
        sources = [FilteredMappedSource(s, filter_params, flag_filters)
                   for s in sources]
    return sources, flag_filters


def build_sharded_mapping_sources(args, filter_params, flag_filters,
                                  genome_exclusion=None):
    """--sharded from raw reads: one ShardedMappingSource per read set,
    spanning every reference (coverm.rs:187-229 / shard_bam_reader.rs:562)."""
    from ..shard import ShardedMappingSource

    refs, _tempfiles = _resolve_references(args)
    params = MappingParameters.generate_from_args(args, refs)
    per_ref_jobs = [jobs for (_ref, jobs) in params.references]
    indexes = [setup_mapping_index(
        ref, args.mapper, threads=args.threads,
        reference_is_index=getattr(args, "minimap2_reference_is_index",
                                   False),
        n_readsets=len(jobs))
        for ref, jobs in params.references]
    n_sets = len(per_ref_jobs[0]) if per_ref_jobs else 0
    sources = []
    for k in range(n_sets):
        jobs_k = [per_ref_jobs[r][k] for r in range(len(refs))]
        sources.append(ShardedMappingSource(
            args.mapper, indexes, jobs_k,
            name_stoit(refs[0], jobs_k[0].read1, False),
            genome_exclusion))
    if filter_params.doing_filtering():
        sources = [FilteredMappedSource(s, filter_params, flag_filters)
                   for s in sources]
    return sources, flag_filters


class FilteredMappedSource:
    """Wrap any source with inline read filtering."""

    def __init__(self, inner, params, flag_filters):
        self.inner = inner
        self.params = params
        self.flag_filters = flag_filters
        self.num_primary_override = None

    @property
    def name(self):
        return self.inner.name

    def read(self):
        from ..readfilter import filter_payload
        header, payload = self.inner.read()
        return header, filter_payload(self, payload, self.params,
                                      self.flag_filters)

    def finish(self):
        self.inner.finish()


def make_bams(args):
    """`coverm make` (coverm.rs:664-723)."""
    out_dir = args.output_directory
    if not os.path.isdir(out_dir):
        os.makedirs(out_dir, exist_ok=True)
    refs, _tempfiles = _resolve_references(args)
    params = MappingParameters.generate_from_args(args, refs)
    for ref, jobs in params.references:
        index = setup_mapping_index(
            ref, args.mapper, threads=args.threads,
            reference_is_index=getattr(args, "minimap2_reference_is_index",
                                       False),
            n_readsets=len(jobs))
        for job in jobs:
            out_path = os.path.join(
                out_dir,
                os.path.basename(ref) + "." + os.path.basename(job.read1)
                + ".bam")
            src = MappedReadsSource(
                args.mapper, index, job, name_stoit(ref, job.read1, True),
                cached_bam_path=out_path,
                discard_unmapped=getattr(args, "discard_unmapped", False))
            _header, payload = src.read()
            if not hasattr(payload, "tid"):
                for _ in payload:  # spilled stream: cache written en route
                    pass
        index.cleanup()
    return 0


def makedb(args):
    """`coverm makedb` (coverm.rs:725-905)."""
    from .index import generate_persistent_index
    if args.reference:
        refs = list(args.reference)
    else:
        from ..commands import (checkm_filter_genomes,
                                parse_list_of_genome_fasta_files)
        genome_files = parse_list_of_genome_fasta_files(args)
        if not genome_files:
            raise SystemExit("makedb needs -r or genome FASTA files")
        genome_files = checkm_filter_genomes(args, genome_files)
        if getattr(args, "dereplicate", False):
            from ..derep import dereplicate
            genome_files = dereplicate(args, genome_files)
        os.makedirs(args.output_directory, exist_ok=True)
        refs = [generate_concatenated_fasta_file(
            genome_files, os.path.join(args.output_directory,
                                       "coverm_concatenated_genomes.fna"))]
    for ref in refs:
        out = generate_persistent_index(ref, args.mapper,
                                        args.output_directory, args.threads)
        print(f"Generated {args.mapper} database at {out}")
        print(f"Use it with e.g.: coverm-tpu contig -r {out} "
              f"-p {args.mapper} -1 reads_1.fq -2 reads_2.fq")
    return 0
