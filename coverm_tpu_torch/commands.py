"""Subcommand implementations (the orchestration layer, bin/coverm.rs)."""

from __future__ import annotations

import os
import sys

from . import CONCATENATED_FASTA_FILE_SEPARATOR
from .cli import (EstimatorsAndTaker, filter_params_from_args,
                  flag_filter_from_args)
from .flags import FlagFilter
from .genome_parsing import (read_genome_definition_file,
                             read_genome_fasta_files)
from .modes import (BamFileSource, contig_coverage, genome_coverage_named,
                    genome_coverage_separator)
from .readfilter import FilterParams
from .takers import OutputWriter


class FilteredBamFileSource(BamFileSource):
    """BAM source with inline read/pair filtering
    (StreamingFilteredNamedBamReader semantics, bam_generator.rs:609-775).

    A streamed BGZF BAM under a single-read-only filter (metabat's 97%
    identity preset, any --min-read-* without a pair threshold) stays on
    the fused native scan, which applies the filter in its record loop
    and counts the primary alignments before it, as filter_payload does.
    Pair filters, CRAM, the whole-file route and COVERM_TPU_FUSED=0 take
    the classic batches through filter_payload."""

    def __init__(self, path, params: FilterParams, flag_filters: FlagFilter,
                 stoit_name=None, device=None):
        super().__init__(path, stoit_name, device)
        self.params = params
        self.flag_filters = flag_filters
        self.num_primary_override = None

    def read(self):
        from .io.fastscan import FusedScanStream
        from .readfilter import filter_payload

        header, payload = super().read()
        if isinstance(payload, FusedScanStream):
            return header, payload.filtered(self, self.params,
                                            self.flag_filters)
        return header, filter_payload(self, payload, self.params,
                                      self.flag_filters)


def _build_sources(args, device=None):
    fp = filter_params_from_args(args)
    ff = flag_filter_from_args(args)
    if getattr(args, "methods", None) and "metabat" in args.methods:
        # MetaBAT adjusted coverage preset (coverm.rs:1680-1693)
        fp.min_percent_identity_single = 0.97001
        ff.include_improper_pairs = True
        ff.include_supplementary = True
        ff.include_secondary = True

    # every source hands its records to modes/genes, which scan them on
    # the device the command was given; a streamed BAM's classic batches
    # inflate and parse on it too
    if args.bam_files:
        if getattr(args, "sharded", False):
            from .shard import ShardedBamSource
            sources = [ShardedBamSource(args.bam_files,
                                        _genome_exclusion_of(args),
                                        device=device)]
            if fp.doing_filtering():
                from .mapping.pipeline import FilteredMappedSource
                sources = [FilteredMappedSource(s, fp, ff) for s in sources]
        elif fp.doing_filtering():
            sources = [FilteredBamFileSource(p, fp, ff, device=device)
                       for p in args.bam_files]
        else:
            sources = [BamFileSource(p, device=device)
                       for p in args.bam_files]
        return sources, ff
    # mapping from raw reads
    if getattr(args, "sharded", False):
        from .mapping.pipeline import build_sharded_mapping_sources
        return build_sharded_mapping_sources(args, fp, ff,
                                             _genome_exclusion_of(args))
    from .mapping import build_mapping_sources
    return build_mapping_sources(args, fp, ff)


def _genome_exclusion_of(args):
    """--exclude-genomes-from-deshard wiring (coverm.rs:96-156): with a
    separator use name-prefix exclusion; with genome FASTAs/definition
    use the (pre-dereplication) contig->genome map."""
    import logging

    from .genome_exclusion import (GenomesAndContigsExclusionFilter,
                                   NoExclusionGenomeFilter,
                                   SeparatorGenomeExclusionFilter)
    path = getattr(args, "exclude_genomes_from_deshard", None)
    if not path:
        return NoExclusionGenomeFilter()
    try:
        with open(path) as f:
            genomes = [l.strip() for l in f if l.strip()]
    except OSError:
        raise SystemExit(
            f"Failed to open file '{path}' containing list of excluded "
            "genomes")
    if not genomes:
        logging.warning(
            "No genomes read in that are to be excluded from desharding "
            "process")
        return NoExclusionGenomeFilter()
    logging.info(
        "Read in %d distinct genomes to exclude from desharding process "
        "e.g. '%s'", len(set(genomes)), genomes[0])
    separator = parse_separator(args) if hasattr(args, "single_genome") \
        else getattr(args, "separator", None)
    if separator is not None:
        return SeparatorGenomeExclusionFilter(genomes, separator)
    gc = getattr(args, "_predereplication_genomes_and_contigs", None)
    if gc is None:
        files = getattr(args, "_predereplication_genome_files", None) or \
            parse_list_of_genome_fasta_files(args)
        if files:
            gc = read_genome_fasta_files(
                files, getattr(args, "use_full_contig_names", False))
        elif getattr(args, "genome_definition", None):
            gc = read_genome_definition_file(args.genome_definition)
    if gc is None:
        # no genome metadata at all: fall back to the concatenated-FASTA
        # separator convention
        return SeparatorGenomeExclusionFilter(
            genomes, CONCATENATED_FASTA_FILE_SEPARATOR)
    return GenomesAndContigsExclusionFilter(gc, genomes)


def _output_stream(args):
    """The -o stream; os.devnull on the non-zero ranks of a
    multi-process job, whose statistics equal rank 0's."""
    from .parallel.distributed import suppress_output
    return OutputWriter(os.devnull if suppress_output() else args.output_file)


def run_contig(args, device=None):
    stream = _output_stream(args)
    et = EstimatorsAndTaker(args, stream)
    entry_type = "Gene\tContig" if args.gff else "Contig"
    et.print_headers(entry_type, stream)
    if args.methods == ["strobealign-aemb"]:
        from .mapping.aemb import strobealign_aemb_coverage
        return strobealign_aemb_coverage(args, et, stream)
    sources, ff = _build_sources(args, device)
    if args.gff:
        from .genes import GeneDefinitions, gene_coverage
        defs = GeneDefinitions.read_gff(args.gff, args.gff_feature_type)
        reads_mapped = gene_coverage(
            sources, et.taker, et.estimators, defs, None,
            print_zero_coverage_genes=not args.no_zeros,
            flag_filter=ff, threads=args.threads, device=device)
    else:
        reads_mapped = contig_coverage(
            sources, et.taker, et.estimators,
            print_zero_coverage_contigs=not args.no_zeros,
            flag_filter=ff, threads=args.threads, device=device)
    et.printer.finalise_printing(
        et.taker, stream, reads_mapped, et.columns_to_normalise,
        et.rpkm_column, et.tpm_column)
    stream.flush()
    return 0


def parse_list_of_genome_fasta_files(args):
    if args.genome_fasta_files:
        return list(args.genome_fasta_files)
    if args.genome_fasta_directory:
        ext = args.genome_fasta_extension
        paths = sorted(
            os.path.join(args.genome_fasta_directory, f)
            for f in os.listdir(args.genome_fasta_directory)
            if f.endswith("." + ext))
        if not paths:
            raise SystemExit(
                f"Found 0 genomes from the genome-fasta-directory, cannot continue")
        return paths
    if args.genome_fasta_list:
        with open(args.genome_fasta_list) as f:
            return [l.strip() for l in f if l.strip()]
    return None


def parse_separator(args):
    """parse_separator (coverm.rs:1522-1537)."""
    if args.single_genome:
        return "0"
    if args.separator:
        return args.separator
    if args.bam_files or args.reference:
        return None
    return CONCATENATED_FASTA_FILE_SEPARATOR


def checkm_filter_genomes(args, genome_fasta_files):
    """CheckM quality pre-filter (resolve_and_checkm_filter_genomes,
    coverm.rs:1143-1189)."""
    from .derep import resolve_quality
    from .genome_parsing import genome_name_from_path
    min_comp = getattr(args, "min_completeness", None)
    max_cont = getattr(args, "max_contamination", None)
    if min_comp is None and max_cont is None:
        return genome_fasta_files
    quality = resolve_quality(args, genome_fasta_files,
                              threads=getattr(args, "threads", 1))
    if not quality:
        raise SystemExit(
            "You must provide a CheckM tab table, CheckM2 quality report, "
            "genome info file, or use --run-checkm2 to use "
            "--min-completeness or --max-contamination")
    out = []
    for g in genome_fasta_files:
        q = quality.get(genome_name_from_path(g))
        if q is None:
            raise SystemExit(
                f"Genome {g} has no entry in the provided quality table")
        if min_comp is not None and q.completeness < min_comp:
            continue
        if max_cont is not None and q.contamination > max_cont:
            continue
        out.append(g)
    if not out:
        raise SystemExit(
            "All genomes were removed by the quality filter, so none remain "
            "to be mapped to")
    return out


def run_genome(args, device=None):
    genome_fasta_files = parse_list_of_genome_fasta_files(args)
    if genome_fasta_files:
        genome_fasta_files = checkm_filter_genomes(args, genome_fasta_files)
        # deshard exclusion uses the PRE-dereplication genome set
        # (genomes_and_contigs_option_predereplication, coverm.rs:136-146)
        args._predereplication_genome_files = list(genome_fasta_files)
        if getattr(args, "dereplicate", False):
            from .derep import dereplicate
            genome_fasta_files = dereplicate(args, genome_fasta_files)
            args.genome_fasta_files = genome_fasta_files
            args.genome_fasta_directory = None
            args.genome_fasta_list = None
    separator = parse_separator(args)

    genomes_and_contigs = None
    if args.single_genome or args.separator:
        pass
    elif args.genome_definition:
        genomes_and_contigs = read_genome_definition_file(args.genome_definition)
    elif genome_fasta_files:
        genomes_and_contigs = read_genome_fasta_files(
            genome_fasta_files, args.use_full_contig_names)
    elif separator is None:
        raise SystemExit(
            "Either a separator (-s) or path(s) to genome FASTA files "
            "(with -d or -f) must be given")

    stream = _output_stream(args)
    et = EstimatorsAndTaker(args, stream)
    et.print_headers("Gene\tContig\tGenome" if args.gff else "Genome", stream)
    sources, ff = _build_sources(args, device)

    if args.gff:
        # genome namer precedence mirrors run_genome (coverm.rs:1554-1580)
        if args.single_genome:
            namer = lambda contig: "genome1"
        elif separator is not None:
            sep = separator

            def namer(contig, sep=sep):
                return contig.split(sep, 1)[0] if sep in contig else None
        else:
            gc = genomes_and_contigs
            namer = lambda contig: gc.genome_of_contig(contig)
        from .genes import GeneDefinitions, gene_coverage
        defs = GeneDefinitions.read_gff(args.gff, args.gff_feature_type)
        reads_mapped = gene_coverage(
            sources, et.taker, et.estimators, defs, namer,
            print_zero_coverage_genes=not args.no_zeros,
            flag_filter=ff, threads=args.threads, device=device)
    elif separator is not None or args.single_genome:
        reads_mapped = genome_coverage_separator(
            sources, separator, et.taker, et.estimators,
            print_zero_coverage_genomes=not args.no_zeros,
            flag_filter=ff, single_genome=args.single_genome,
            threads=args.threads, device=device)
    else:
        reads_mapped = genome_coverage_named(
            sources, genomes_and_contigs, et.taker, et.estimators,
            print_zero_coverage_genomes=not args.no_zeros,
            flag_filter=ff, threads=args.threads, device=device)

    et.printer.finalise_printing(
        et.taker, stream, reads_mapped, et.columns_to_normalise,
        et.rpkm_column, et.tpm_column)
    stream.flush()
    return 0


def run_filter(args, device=None):
    """`coverm filter`: rewrite BAMs keeping only passing alignments
    (coverm.rs:408-472), their records inflated and parsed on `device`
    (device.resolve_device: None is the card)."""
    if len(args.bam_files) != len(args.output_bam_files):
        raise SystemExit(
            "The number of input BAM files must be the same as the number "
            "output")
    fp = filter_params_from_args(args)
    ff = flag_filter_from_args(args)
    from .filter_stream import stream_filter_bam
    for in_path, out_path in zip(args.bam_files, args.output_bam_files):
        # reference semantics: filter_out=true is the normal mode, --inverse
        # flips it (coverm.rs:453 passes !inverse).  Streaming rewrite —
        # memory bounded by segment size, multi-GB headers copied through
        # in chunks (test_cmdline.rs:4212-4369).
        tmp = None
        orig_path = in_path
        with open(in_path, "rb") as f:
            magic = f.read(4)
        if magic == b"CRAM":
            # htslib reads CRAM transparently and `filter` writes BAM
            # out (lib.rs:138-180); lower CRAM containerwise to an
            # uncompressed BAM spool, then stream-filter that
            import mmap
            import tempfile
            from .io import bgzf
            from .io.cram import iter_bam_segments
            tmp = tempfile.NamedTemporaryFile(suffix=".bam", delete=False)
            try:
                with open(in_path, "rb") as f:
                    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                    try:
                        # require_seq: rewriting records needs real bases;
                        # fail loudly rather than emit all-'N' sequences
                        for seg in iter_bam_segments(mm, require_seq=True):
                            for o in range(0, len(seg), 0xFF00):
                                tmp.write(bgzf.compress_block(
                                    bytes(seg[o:o + 0xFF00]), 1))
                    finally:
                        mm.close()
                tmp.write(bgzf.BGZF_EOF)
                tmp.close()
            except BaseException:
                tmp.close()
                os.unlink(tmp.name)
                raise
            in_path = tmp.name
        try:
            kept, total = stream_filter_bam(in_path, out_path, fp, ff,
                                            inverse=args.inverse,
                                            device=device)
        finally:
            if tmp is not None:
                os.unlink(tmp.name)
        print(
            f"In sample '{os.path.basename(orig_path)}', found "
            f"{kept} reads passing filter out of {total} total",
            file=sys.stderr)
    return 0


def run_make(args):
    from .mapping import make_bams
    return make_bams(args)


def run_makedb(args):
    from .mapping import makedb
    return makedb(args)


def run_cluster(args):
    """`coverm cluster` (coverm.rs:921-927 via the galah bridge)."""
    from .derep import dereplicate
    genome_fasta_files = parse_list_of_genome_fasta_files(args)
    if not genome_fasta_files:
        raise SystemExit("cluster requires genome FASTA files (-f/-d)")
    genome_fasta_files = checkm_filter_genomes(args, genome_fasta_files)
    args.dereplication_reference_genomes = getattr(
        args, "reference_genomes", None)
    args.dereplication_ani = args.ani
    args.dereplication_prethreshold_ani = args.prethreshold_ani
    args.dereplication_quality_formula = args.quality_formula
    args.dereplication_output_cluster_definition = args.output_cluster_definition
    args.dereplication_output_representative_list = args.output_representative_list
    args.dereplication_output_representative_fasta_directory = (
        args.output_representative_fasta_directory)
    reps = dereplicate(args, genome_fasta_files)
    print(f"Found {len(reps)} cluster representatives", file=sys.stderr)
    if not (args.output_cluster_definition or args.output_representative_list
            or args.output_representative_fasta_directory
            or args.output_representative_fasta_directory_copy):
        for r in reps:
            print(r)
    return 0


def _completion_flag_map():
    """Per-subcommand long/short option strings, straight from the
    argparse definitions (the analogue of clap_complete generating from
    build_cli(), coverm.rs:907-920)."""
    from .cli import build_parser
    parser = build_parser()
    out = {}
    for name, subp in parser._subparser_map.items():
        flags = []
        for action in subp._actions:
            flags.extend(action.option_strings)
        out[name] = flags
    return out


def run_shell_completion(args):
    """Generate a completion script for the given shell — the same five
    shells clap_complete supports (coverm.rs:907-920)."""
    prog = "coverm-tpu"
    flag_map = _completion_flag_map()
    subcommands = list(flag_map)

    if args.shell == "bash":
        cases = "\n".join(
            f"    {name})\n"
            f"      COMPREPLY=( $(compgen -W \"{' '.join(flags)}\" -- \"$cur\") )\n"
            "      ;;"
            for name, flags in flag_map.items())
        script = (
            "_coverm_tpu() {\n"
            "  local cur=${COMP_WORDS[COMP_CWORD]}\n"
            "  local sub=${COMP_WORDS[1]}\n"
            "  if [ $COMP_CWORD -eq 1 ]; then\n"
            f"    COMPREPLY=( $(compgen -W \"{' '.join(subcommands)}\" -- \"$cur\") )\n"
            "    return\n"
            "  fi\n"
            "  case \"$sub\" in\n"
            f"{cases}\n"
            "  esac\n"
            "}\n"
            f"complete -o default -F _coverm_tpu {prog}\n")
    elif args.shell == "zsh":
        cases = "\n".join(
            f"    {name}) _arguments '*: :({' '.join(flags)})' '*: :_files' ;;"
            for name, flags in flag_map.items())
        script = (
            f"#compdef {prog}\n"
            "if (( CURRENT == 2 )); then\n"
            f"  _arguments '1: :({' '.join(subcommands)})'\n"
            "else\n"
            "  case $words[2] in\n"
            f"{cases}\n"
            "  esac\n"
            "fi\n")
    elif args.shell == "fish":
        lines = [f"complete -c {prog} -n '__fish_use_subcommand' -a '{name}'"
                 for name in subcommands]
        for name, flags in flag_map.items():
            for fl in flags:
                if fl.startswith("--"):
                    lines.append(
                        f"complete -c {prog} -n '__fish_seen_subcommand_from "
                        f"{name}' -l {fl[2:]}")
                elif len(fl) == 2:
                    lines.append(
                        f"complete -c {prog} -n '__fish_seen_subcommand_from "
                        f"{name}' -s {fl[1:]}")
        script = "\n".join(lines) + "\n"
    elif args.shell == "powershell":
        def ps_list(items):
            return ", ".join(f"'{x}'" for x in items)
        entries = "\n".join(
            f"        '{name}' {{ @({ps_list(flags)}) }}"
            for name, flags in flag_map.items())
        script = (
            f"Register-ArgumentCompleter -Native -CommandName {prog} "
            "-ScriptBlock {\n"
            "    param($wordToComplete, $commandAst, $cursorPosition)\n"
            "    $words = $commandAst.CommandElements | "
            "ForEach-Object { $_.ToString() }\n"
            "    $completions = if ($words.Count -le 2) {\n"
            f"        @({ps_list(subcommands)})\n"
            "    } else { switch ($words[1]) {\n"
            f"{entries}\n"
            "    } }\n"
            "    $completions | Where-Object { $_ -like \"$wordToComplete*\" } |\n"
            "        ForEach-Object { [System.Management.Automation."
            "CompletionResult]::new($_, $_, 'ParameterValue', $_) }\n"
            "}\n")
    elif args.shell == "elvish":
        all_flags = sorted({f for fl in flag_map.values() for f in fl})
        script = (
            f"set edit:completion:arg-completer[{prog}] = {{|@words|\n"
            "  if (== (count $words) 2) {\n"
            f"    put {' '.join(subcommands)}\n"
            "  } else {\n"
            f"    put {' '.join(all_flags)}\n"
            "  }\n"
            "}\n")
    else:
        raise SystemExit(f"Unsupported shell: {args.shell}")
    with open(args.output_file, "w") as f:
        f.write(script)
    return 0
