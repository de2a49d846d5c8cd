"""Subcommand implementations (the orchestration layer, bin/coverm.rs)."""

from __future__ import annotations

import os

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


def unsupported(what: str):
    """Exit for a route this package does not run yet."""
    raise SystemExit(f"Error: {what} is not yet supported by "
                     "coverm_tpu_torch")


class FilteredBamFileSource(BamFileSource):
    """BAM source with inline read/pair filtering
    (StreamingFilteredNamedBamReader semantics, bam_generator.rs:609-775)."""

    def __init__(self, path, params: FilterParams, flag_filters: FlagFilter,
                 stoit_name=None):
        super().__init__(path, stoit_name)
        self.params = params
        self.flag_filters = flag_filters
        self.num_primary_override = None

    def read(self):
        from .readfilter import filter_payload
        header, payload = super().read()
        return header, filter_payload(self, payload, self.params,
                                      self.flag_filters)


def _build_sources(args):
    fp = filter_params_from_args(args)
    ff = flag_filter_from_args(args)
    if getattr(args, "methods", None) and "metabat" in args.methods:
        # MetaBAT adjusted coverage preset (coverm.rs:1680-1693)
        fp.min_percent_identity_single = 0.97001
        ff.include_improper_pairs = True
        ff.include_supplementary = True
        ff.include_secondary = True

    if getattr(args, "sharded", False):
        unsupported("--sharded")
    if not args.bam_files:
        unsupported("mapping from reads (give -b sorted BAM files)")
    if fp.doing_filtering():
        sources = [FilteredBamFileSource(p, fp, ff) for p in args.bam_files]
    else:
        sources = [BamFileSource(p) for p in args.bam_files]
    return sources, ff


def _check_slice(args):
    """Exit early for options outside this package's routes."""
    if args.gff:
        unsupported("--gff")
    if args.methods == ["strobealign-aemb"]:
        unsupported("the strobealign-aemb method")


def run_contig(args, device=None):
    _check_slice(args)
    stream = OutputWriter(args.output_file)
    et = EstimatorsAndTaker(args, stream)
    et.print_headers("Contig", stream)
    sources, ff = _build_sources(args)
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


def run_genome(args, device=None):
    _check_slice(args)
    genome_fasta_files = parse_list_of_genome_fasta_files(args)
    if genome_fasta_files:
        if (getattr(args, "min_completeness", None) is not None
                or getattr(args, "max_contamination", None) is not None):
            unsupported("the CheckM quality filter")
        if getattr(args, "dereplicate", False):
            unsupported("--dereplicate")
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

    stream = OutputWriter(args.output_file)
    et = EstimatorsAndTaker(args, stream)
    et.print_headers("Genome", stream)
    sources, ff = _build_sources(args)

    if separator is not None or args.single_genome:
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
