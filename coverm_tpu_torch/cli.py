"""Command-line interface mirroring CoverM's (cli.rs, bin/coverm.rs).

Subcommands: genome, contig, filter, make, makedb, shell-completion.
Flag names and defaults follow cli.rs (genome defaults cli.rs:2027-2100,
contig defaults cli.rs:2501-2574); the estimator/taker/printer wiring
follows EstimatorsAndTaker::generate_from_clap (coverm.rs:1314-1504).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import CONCATENATED_FASTA_FILE_SEPARATOR, __version__
from .estimators import (ANIrEstimator, CoveredBasesEstimator,
                         CoveredFractionEstimator, LengthEstimator,
                         MeanEstimator, PileupCountsEstimator,
                         RPKMEstimator, ReadCountEstimator,
                         ReadsPerBaseEstimator, TPMEstimator,
                         TrimmedMeanEstimator, VarianceEstimator)
from .flags import FlagFilter
from .printers import (DenseCachedCoveragePrinter, MetabatAdjustedCoveragePrinter,
                       SparseCachedCoveragePrinter, StreamedCoveragePrinter)
from .readfilter import FilterParams
from .takers import (CachedCoverageTaker, OutputWriter, PileupCoverageTaker,
                     StreamingCoverageTaker)

METHODS = [
    "relative_abundance", "mean", "trimmed_mean", "coverage_histogram",
    "covered_bases", "covered_fraction", "variance", "length", "count",
    "metabat", "reads_per_base", "rpkm", "tpm", "anir", "strobealign-aemb",
]

MAPPING_SOFTWARE_LIST = [
    "bwa-mem", "bwa-mem2", "minimap2-sr", "minimap2-ont", "minimap2-pb",
    "minimap2-hifi", "minimap2-lr-hq", "minimap2-no-preset", "strobealign",
    "minibwa", "rammap-sr", "rammap-ont", "rammap-pb", "rammap-hifi",
    "rammap-lr-hq", "rammap-no-preset",
]
DEFAULT_MAPPING_SOFTWARE = "strobealign"


def parse_percentage(value: float, name: str) -> float:
    """parse_percentage (coverm.rs:1296-1312): 1-100 are percentages."""
    v = float(value)
    if 1.0 <= v <= 100.0:
        v /= 100.0
    elif not (0.0 <= v <= 100.0):
        raise SystemExit(f"Invalid alignment percentage: '{v}'")
    return v


def add_read_args(p):
    """Read-input and mapper flags (cli.rs 'Read mapping parameters'
    section)."""
    p.add_argument("-1", "--read1", dest="read1", nargs="+", default=None,
                   metavar="PATH",
                   help="Forward FASTA/Q read file(s), optionally gzipped; "
                        "pair each with the file at the same position in -2")
    p.add_argument("-2", "--read2", dest="read2", nargs="+", default=None,
                   metavar="PATH",
                   help="Reverse FASTA/Q read file(s), matched 1:1 with -1")
    p.add_argument("-c", "--coupled", nargs="+", default=None, metavar="PATH",
                   help="Forward and reverse read files given as one "
                        "alternating list: sample1_R1 sample1_R2 sample2_R1 "
                        "sample2_R2 ...")
    p.add_argument("--interleaved", nargs="+", default=None, metavar="PATH",
                   help="FASTA/Q file(s) where forward and reverse reads of "
                        "each pair alternate within one file")
    p.add_argument("--single", nargs="+", default=None, metavar="PATH",
                   help="Unpaired FASTA/Q read file(s)")
    p.add_argument("-r", "--reference", nargs="+", default=None,
                   metavar="PATH",
                   help="FASTA file(s) of contigs to map against, or a "
                        "pre-built index for some mappers. Multiple "
                        "references map each sample against each reference "
                        "separately — to pool them, concatenate into one "
                        "FASTA first (or use --sharded)")
    p.add_argument("-p", "--mapper", default=DEFAULT_MAPPING_SOFTWARE,
                   choices=MAPPING_SOFTWARE_LIST, metavar="NAME",
                   help="Read-mapping program (and preset) to run")
    p.add_argument("--minimap2-params", default=None, metavar="PARAMS",
                   help="Extra arguments passed verbatim to minimap2; wrap "
                        "the whole string in quotes")
    p.add_argument("--minimap2-reference-is-index", action="store_true",
                   help="Treat -r as a pre-built minimap2 .mmi index rather "
                        "than a FASTA file (single reference only)")
    p.add_argument("--bwa-params", default=None, metavar="PARAMS",
                   help="Extra arguments passed verbatim to bwa mem / "
                        "bwa-mem2 mem")
    p.add_argument("--minibwa-params", default=None, metavar="PARAMS",
                   help="Extra arguments passed verbatim to minibwa")
    p.add_argument("--strobealign-params", default=None, metavar="PARAMS",
                   help="Extra arguments passed verbatim to strobealign")
    p.add_argument("--strobealign-use-index", action="store_true",
                   help="Load a pre-generated strobealign index (.sti) "
                        "instead of indexing the reference on the fly")
    p.add_argument("--rammap-params", default=None, metavar="PARAMS",
                   help="Extra arguments passed verbatim to rammap")


def add_filter_thresholds(p):
    """Alignment thresholding flags (cli.rs 'Alignment thresholding';
    semantics in filter.rs:243-336)."""
    p.add_argument("--min-read-aligned-length", type=int, default=0,
                   metavar="INT",
                   help="Discard reads aligning fewer than this many bases "
                        "(CIGAR M/I/D/X/= total)")
    p.add_argument("--min-read-percent-identity", type=float, default=0.0,
                   metavar="FLOAT",
                   help="Discard reads whose identity over aligned bases "
                        "(1 - NM/aligned) is below this percentage, "
                        "e.g. 95 means 95%%")
    p.add_argument("--min-read-aligned-percent", type=float, default=0.0,
                   metavar="FLOAT",
                   help="Discard reads where fewer than this percentage of "
                        "the read's bases are aligned, e.g. 95 means 95%%")
    p.add_argument("--min-read-aligned-length-pair", type=int, default=0,
                   metavar="INT",
                   help="Discard pairs whose summed aligned bases fall below "
                        "this count; implies --proper-pairs-only")
    p.add_argument("--min-read-percent-identity-pair", type=float,
                   default=0.0, metavar="FLOAT",
                   help="Discard pairs whose combined percent identity is "
                        "below this value; implies --proper-pairs-only")
    p.add_argument("--min-read-aligned-percent-pair", type=float,
                   default=0.0, metavar="FLOAT",
                   help="Discard pairs whose combined aligned-base "
                        "percentage is below this value; implies "
                        "--proper-pairs-only")
    p.add_argument("--min-mapq", type=int, default=255, metavar="INT",
                   help="Discard reads with mapping quality below this "
                        "value (0-254); for pairs, both mates are dropped "
                        "if either fails. MAPQ 255 (unavailable) always "
                        "fails when this flag is set")
    p.add_argument("--proper-pairs-only", action="store_true",
                   help="Keep only reads mapped as proper pairs")
    p.add_argument("--include-secondary", action="store_true",
                   help="Keep secondary alignments (dropped by default)")
    p.add_argument("--exclude-supplementary", action="store_true",
                   help="Drop supplementary alignments (kept by default)")


def add_coverage_args(p, genome_mode: bool):
    default_method = "relative_abundance" if genome_mode else "mean"
    default_min_frac = "10" if genome_mode else "0"
    # per-mode method value lists (cli.rs:2033-2047 genome has no
    # metabat/strobealign-aemb; cli.rs:2505-2519 contig has no
    # relative_abundance) — rejected at parse time
    if genome_mode:
        methods = [m for m in METHODS
                   if m not in ("metabat", "strobealign-aemb")]
    else:
        methods = [m for m in METHODS if m != "relative_abundance"]
    method_help = (
        "Coverage statistic(s) to report, one column per method per "
        "sample. "
        + ("relative_abundance: percentage of the community each genome "
           "accounts for (default, genome mode only). " if genome_mode
           else "")
        + "mean: average depth over each position"
        + (" (contig-mode default)" if not genome_mode else "")
        + ". trimmed_mean: mean after dropping the most and least covered "
          "positions (see --trim-min/--trim-max). "
          "coverage_histogram: one row per observed depth with the number "
          "of bases at that depth. "
          "covered_fraction / covered_bases: proportion / count of "
          "positions with depth >= 1. "
          "variance: sample variance of per-position depth. "
          "length: reference length in bp. "
          "count: reads mapped (supplementary alignments not counted). "
          "reads_per_base: reads mapped divided by length. "
          "rpkm: reads per kilobase per million mapped reads. "
          "tpm: transcripts-per-million normalisation of rpkm. "
          "anir: average identity of mapped reads (percent)."
        + ("" if genome_mode else
           " metabat: the MetaBAT 'adjusted coverage' table (Kang et al "
           "2015), incompatible with other methods. strobealign-aemb: "
           "abundances estimated by strobealign --aemb (reads input "
           "only, not combinable with other methods)."))
    p.add_argument("-m", "--methods", nargs="+", default=[default_method],
                   choices=methods, metavar="METHOD", help=method_help)
    p.add_argument("--min-covered-fraction", type=float,
                   default=float(default_min_frac), metavar="FRACTION",
                   help="Entries with a smaller fraction of covered bases "
                        "are reported as zero coverage, e.g. 10 means 10%%")
    p.add_argument("--contig-end-exclusion", type=int, default=75,
                   metavar="INT",
                   help="Ignore this many bases at each end of every "
                        "reference sequence when computing depth statistics")
    p.add_argument("--trim-min", type=float, default=5.0, metavar="FRACTION",
                   help="For trimmed_mean: discard positions below this "
                        "depth percentile")
    p.add_argument("--trim-max", type=float, default=95.0,
                   metavar="FRACTION",
                   help="For trimmed_mean: discard positions above this "
                        "depth percentile")
    p.add_argument("--no-zeros", action="store_true",
                   help="Do not print entries with zero coverage")
    p.add_argument("--output-format", default="dense",
                   choices=["sparse", "dense"],
                   help="dense: one row per entry, one column block per "
                        "sample; sparse: long format with one row per "
                        "(sample, entry)")
    p.add_argument("-o", "--output-file", default=None, metavar="FILE",
                   help="Write the coverage table here instead of stdout "
                        "('-' keeps stdout)")
    p.add_argument("-t", "--threads", type=int, default=1, metavar="INT",
                   help="Threads for mapping and BAM decoding")
    p.add_argument("-b", "--bam-files", nargs="+", default=None,
                   metavar="PATH",
                   help="Pre-mapped, reference-sorted BAM file(s) to read "
                        "instead of mapping raw reads")
    p.add_argument("--sharded", action="store_true",
                   help="With -b: treat the BAMs as read-name-sorted shards "
                        "of one read set mapped against split references, "
                        "and keep only each read's best (highest "
                        "alignment-score) hit across shards. With raw "
                        "reads: map against each reference separately and "
                        "merge the same way")
    p.add_argument("--discard-unmapped", action="store_true",
                   help="Leave unmapped reads out of cached BAM files")
    p.add_argument("--bam-file-cache-directory",
                   "--cache-unfiltered-bam-directory",
                   dest="bam_file_cache_directory", default=None,
                   metavar="DIR",
                   help="Keep the BAMs produced while mapping raw reads in "
                        "this directory (created if absent); without this "
                        "flag they are discarded after the run")
    p.add_argument("--cache-unfiltered-bam-files", nargs="+", default=None,
                   metavar="PATH",
                   help="Explicit cache BAM paths, one per read set, ordered "
                        "single(-s)/-1 -2/--coupled/--interleaved "
                        "(cli.rs:1026, coverm.rs:1942-1988)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Print extra debugging information")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="Print only errors")
    p.add_argument("--gff", default=None, metavar="PATH",
                   help="GFF/GTF file of features: report coverage once per "
                        "feature instead of per contig, with the feature id "
                        "(from ID, locus_tag, gene_id, Name, gene or Parent "
                        "attributes) and its contig leading each row. "
                        "Read-count methods assign a read to the feature "
                        "containing its leftmost mapped position. "
                        "--contig-end-exclusion applies per feature, so 0 "
                        "may suit short genes. Not usable with metabat or "
                        "strobealign-aemb")
    p.add_argument("--gff-feature-type", default=None, metavar="TYPE",
                   help="With --gff: only use features whose third column "
                        "matches TYPE (default: all features)")
    # observability (SURVEY.md §5: profiling hooks are first-class here,
    # unlike the reference which has only log levels)
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="Write a JAX/XLA profiler trace (viewable with "
                        "xprof/tensorboard) for the coverage run to DIR")


def add_dereplication_args(p, prefix=""):
    """galah-bridged clustering flags (cli.rs:35-66, 1382-1445)."""
    d = prefix.replace("-", "_")
    p.add_argument(f"--{prefix}ani", dest=f"{d}ani", type=float, default=95.0,
                   metavar="FLOAT",
                   help="Average nucleotide identity threshold (percent) at "
                        "which two genomes join the same cluster")
    p.add_argument(f"--{prefix}prethreshold-ani",
                   dest=f"{d}prethreshold_ani", type=float, default=90.0,
                   metavar="FLOAT",
                   help="Looser ANI used by the fast preclustering pass; "
                        "only genome pairs passing it are compared at the "
                        "full threshold. Must not exceed the main ANI")
    p.add_argument(f"--{prefix}quality-formula", dest=f"{d}quality_formula",
                   default="completeness-4contamination",
                   choices=["completeness-4contamination",
                            "completeness-5contamination", "Parks2020_reduced",
                            "dRep"],
                   help="Score used to rank genomes when choosing each "
                        "cluster's representative from CheckM quality "
                        "values")
    p.add_argument(f"--{prefix}precluster-method",
                   dest=f"{d}precluster_method", default="dashing",
                   metavar="NAME",
                   help="Sketching engine for the preclustering pass "
                        "(built-in FracMinHash sketches serve this role "
                        "here)")
    p.add_argument(f"--{prefix}cluster-method", dest=f"{d}cluster_method",
                   default="skani", metavar="NAME",
                   help="ANI engine for final clustering: skani or fastani "
                        "(external executables, required on $PATH), or "
                        "'sketch' for the built-in FracMinHash estimate")
    p.add_argument(f"--{prefix}aligned-fraction",
                   dest=f"{d}aligned_fraction", type=float, default=15.0,
                   metavar="FLOAT",
                   help="Minimum percentage of the genome pair that must "
                        "align for the ANI comparison to count")
    p.add_argument(f"--{prefix}fragment-length", dest=f"{d}fragment_length",
                   type=int, default=3000, metavar="INT",
                   help="Fragment length used by fastANI comparisons")
    p.add_argument(f"--{prefix}output-cluster-definition",
                   dest=f"{d}output_cluster_definition", default=None,
                   metavar="PATH",
                   help="Write a two-column TSV mapping each cluster "
                        "representative to every member genome")
    p.add_argument(f"--{prefix}output-representative-fasta-directory",
                   dest=f"{d}output_representative_fasta_directory",
                   default=None, metavar="DIR",
                   help="Symlink each representative genome's FASTA into "
                        "this directory")
    p.add_argument(f"--{prefix}output-representative-fasta-directory-copy",
                   dest=f"{d}output_representative_fasta_directory_copy",
                   default=None, metavar="DIR",
                   help="Copy (not symlink) each representative genome's "
                        "FASTA into this directory")
    p.add_argument(f"--{prefix}output-representative-list",
                   dest=f"{d}output_representative_list", default=None,
                   metavar="PATH",
                   help="Write the representative genome paths, one per "
                        "line")
    p.add_argument(f"--{prefix}reference-genomes",
                   dest=f"{d}reference_genomes", nargs="+", default=None,
                   metavar="PATH",
                   help="Genomes pinned as cluster representatives before "
                        "clustering starts")
    p.add_argument(f"--{prefix}reference-genomes-list",
                   dest=f"{d}reference_genomes_list", default=None,
                   metavar="PATH",
                   help="File listing pinned representative genome paths, "
                        "one per line")
    # galah sketch-granularity knobs (cli.rs:1420-1446); here they tune
    # the FracMinHash sketch density (smaller scale = denser sketch)
    p.add_argument(f"--{prefix}small-genomes", dest=f"{d}small_genomes",
                   action="store_true",
                   help="Densify sketches for small (<1 Mbp) genomes so "
                        "ANI estimates stay accurate")
    p.add_argument(f"--{prefix}small-contigs", dest=f"{d}small_contigs",
                   action="store_true",
                   help="With cluster-contigs: tune sketching for contigs "
                        "down to ~10 kbp")
    p.add_argument(f"--{prefix}large-contigs", dest=f"{d}large_contigs",
                   action="store_true",
                   help="With cluster-contigs: coarser sketching for "
                        "contigs over ~100 kbp")
    p.add_argument(f"--{prefix}cluster-contigs", dest=f"{d}cluster_contigs",
                   action="store_true",
                   help="Cluster individual contigs rather than whole "
                        "genomes (each input sequence becomes a unit)")
    p.add_argument(f"--{prefix}low-memory", dest=f"{d}low_memory",
                   action="store_true",
                   help="Trade speed for lower memory during clustering")


def add_checkm_args(p):
    p.add_argument("--checkm-tab-table", default=None, metavar="PATH",
                   help="CheckM1 quality table (checkm ... --tab_table -f "
                        "PATH) supplying completeness/contamination for "
                        "quality filtering and representative ranking")
    p.add_argument("--checkm2-quality-report", default=None, metavar="PATH",
                   help="CheckM2 quality_report.tsv supplying genome "
                        "quality values")
    p.add_argument("--genome-info", default=None, metavar="PATH",
                   help="dRep genomeInfo CSV (genome,completeness,"
                        "contamination) supplying genome quality values")
    p.add_argument("--min-completeness", type=float, default=None,
                   metavar="FLOAT",
                   help="Drop genomes below this completeness percentage "
                        "before clustering/mapping")
    p.add_argument("--max-contamination", type=float, default=None,
                   metavar="FLOAT",
                   help="Drop genomes above this contamination percentage "
                        "before clustering/mapping")
    # run CheckM2 ourselves instead of taking a pre-made table
    # (galah bridge names, cli.rs:41-42 — unprefixed in every mode)
    p.add_argument("--run-checkm2", action="store_true",
                   help="Run CheckM2 on the input genomes instead of "
                        "reading a pre-made quality table")
    p.add_argument("--checkm2-db-path", default=None, metavar="PATH",
                   help="CheckM2 DIAMOND database to use with --run-checkm2 "
                        "(otherwise CheckM2's default database)")


def build_parser():
    parser = argparse.ArgumentParser(
        prog="coverm-tpu",
        description="Mapping coverage analysis of metagenomes (TPU-native engine)")
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="subcommand")

    g = sub.add_parser("genome", help="Calculate coverage of genomes")
    add_coverage_args(g, genome_mode=True)
    add_read_args(g)
    add_filter_thresholds(g)
    g.add_argument("-s", "--separator", default=None, metavar="CHAR",
                   help="Single character splitting each contig name into "
                        "'genome<CHAR>contig'; everything before the last "
                        "occurrence names the genome (e.g. '~' for contigs "
                        "named genome1~contig3)")
    g.add_argument("-f", "--genome-fasta-files", nargs="+", default=None,
                   metavar="PATH",
                   help="Genome FASTA file(s); each file is one genome, "
                        "named by its file stem")
    g.add_argument("-d", "--genome-fasta-directory", default=None,
                   metavar="DIR",
                   help="Directory of genome FASTA files (see -x for the "
                        "extension)")
    g.add_argument("-x", "--genome-fasta-extension", default="fna",
                   metavar="EXT",
                   help="File extension of genomes found via -d")
    g.add_argument("--genome-fasta-list", default=None, metavar="PATH",
                   help="File listing genome FASTA paths, one per line")
    g.add_argument("--genome-definition", default=None, metavar="PATH",
                   help="Tab-separated file of 'genome_name<TAB>contig' "
                        "rows defining which contigs belong to which "
                        "genome")
    g.add_argument("--single-genome", action="store_true",
                   help="Treat every contig in the reference as one genome")
    g.add_argument("--use-full-contig-names", action="store_true",
                   help="Match contigs by the entire FASTA header line "
                        "instead of only the first whitespace-separated "
                        "token")
    g.add_argument("--exclude-genomes-from-deshard", default=None,
                   metavar="PATH",
                   help="With --sharded: file listing genome names whose "
                        "hits are ignored when choosing each read's best "
                        "shard alignment")
    g.add_argument("--dereplicate", action="store_true",
                   help="Cluster the input genomes at --dereplication-ani "
                        "and map against cluster representatives only")
    add_dereplication_args(g, prefix="dereplication-")
    add_checkm_args(g)

    c = sub.add_parser("contig", help="Calculate coverage of contigs")
    add_coverage_args(c, genome_mode=False)
    add_read_args(c)
    add_filter_thresholds(c)

    f = sub.add_parser("filter", help="Remove alignments with insufficient identity")
    f.add_argument("-b", "--bam-files", nargs="+", required=True,
                   metavar="PATH",
                   help="Reference-sorted input BAM file(s)")
    f.add_argument("-o", "--output-bam-files", nargs="+", required=True,
                   metavar="PATH",
                   help="Output BAM path(s), matched 1:1 with -b")
    f.add_argument("--inverse", action="store_true",
                   help="Keep only the alignments that FAIL the thresholds "
                        "(e.g. to collect off-target reads)")
    f.add_argument("-t", "--threads", type=int, default=1, metavar="INT",
                   help="Threads for BAM decoding/encoding")
    f.add_argument("-v", "--verbose", action="store_true",
                   help="Print extra debugging information")
    f.add_argument("-q", "--quiet", action="store_true",
                   help="Print only errors")
    add_filter_thresholds(f)

    mk = sub.add_parser("make", help="Generate BAM files through mapping")
    add_read_args(mk)
    add_filter_thresholds(mk)
    mk.add_argument("-o", "--output-directory", required=True, metavar="DIR",
                    help="Directory for the generated reference-sorted BAMs "
                         "(created if absent)")
    mk.add_argument("-t", "--threads", type=int, default=1, metavar="INT",
                    help="Threads for mapping")
    mk.add_argument("--discard-unmapped", action="store_true",
                    help="Leave unmapped reads out of the generated BAMs")
    mk.add_argument("-v", "--verbose", action="store_true",
                    help="Print extra debugging information")
    mk.add_argument("-q", "--quiet", action="store_true",
                    help="Print only errors")

    mdb = sub.add_parser("makedb", help="Generate a mapper database from genomes")
    mdb.add_argument("-r", "--reference", nargs="+", default=None,
                     metavar="PATH",
                     help="FASTA file(s) to index")
    mdb.add_argument("-f", "--genome-fasta-files", nargs="+", default=None,
                     metavar="PATH",
                     help="Genome FASTA file(s) to concatenate (contigs "
                          "renamed genome~contig) and index")
    mdb.add_argument("-d", "--genome-fasta-directory", default=None,
                     metavar="DIR",
                     help="Directory of genome FASTAs to concatenate and "
                          "index")
    mdb.add_argument("-x", "--genome-fasta-extension", default="fna",
                     metavar="EXT",
                     help="File extension of genomes found via -d")
    mdb.add_argument("--genome-fasta-list", default=None, metavar="PATH",
                     help="File listing genome FASTA paths, one per line")
    mdb.add_argument("-o", "--output-directory", required=True, metavar="DIR",
                     help="Where to write the persistent mapper index")
    mdb.add_argument("-p", "--mapper", default="minimap2-sr",
                     choices=MAPPING_SOFTWARE_LIST, metavar="NAME",
                     help="Mapper whose index format to generate")
    mdb.add_argument("-t", "--threads", type=int, default=1, metavar="INT",
                     help="Threads for index construction")
    mdb.add_argument("-v", "--verbose", action="store_true",
                     help="Print extra debugging information")
    mdb.add_argument("-q", "--quiet", action="store_true",
                     help="Print only errors")
    # optional dereplication before concatenation (coverm.rs:748-752)
    mdb.add_argument("--dereplicate", action="store_true",
                     help="Cluster the genomes first and index only the "
                          "cluster representatives")
    add_dereplication_args(mdb, prefix="dereplication-")
    add_checkm_args(mdb)

    cl = sub.add_parser("cluster", help="Dereplicate and cluster genomes")
    cl.add_argument("-f", "--genome-fasta-files", nargs="+", default=None,
                    metavar="PATH",
                    help="Genome FASTA file(s) to cluster")
    cl.add_argument("-d", "--genome-fasta-directory", default=None,
                    metavar="DIR",
                    help="Directory of genome FASTAs to cluster")
    cl.add_argument("-x", "--genome-fasta-extension", default="fna",
                    metavar="EXT",
                    help="File extension of genomes found via -d")
    cl.add_argument("--genome-fasta-list", default=None, metavar="PATH",
                    help="File listing genome FASTA paths, one per line")
    cl.add_argument("-t", "--threads", type=int, default=1, metavar="INT",
                    help="Threads for ANI comparisons")
    add_dereplication_args(cl, prefix="")
    add_checkm_args(cl)

    sc = sub.add_parser("shell-completion", help="Generate shell completions")
    sc.add_argument("--shell", required=True,
                    choices=["bash", "zsh", "fish", "elvish", "powershell"],
                    help="Shell dialect to emit completions for")
    sc.add_argument("-o", "--output-file", required=True, metavar="FILE",
                    help="Write the completion script here ('-' for stdout)")

    parser._subparser_map = {"genome": g, "contig": c, "filter": f,
                             "make": mk, "makedb": mdb, "cluster": cl,
                             "shell-completion": sc}
    descriptions = {
        "genome": "Calculate read coverage per genome",
        "contig": "Calculate read coverage per contig",
        "filter": "Remove alignments with insufficient identity",
        "make": "Generate BAM files through mapping",
        "makedb": "Generate a mapper database from genome FASTA files",
        "cluster": "Dereplicate and get representative genomes",
        "shell-completion": "Generate a shell completion script",
    }
    # EXAMPLES + FAQ content surfaced by --full-help/--full-help-roff
    # (the reference renders equivalent sections into its man pages,
    # cli.rs:354-373 FAQ and the per-subcommand example blocks)
    faq = (
        "Thresholding arguments such as --min-read-percent-identity and "
        "--dereplication-ani accept either percentages (95 means 95%) or "
        "fractions (0.95); values between 0 and 1 are read as fractions. "
        "Input read and genome files may be gzip-compressed.")
    examples = {
        "genome": [
            ("Map paired reads to a database of genomes at database/ and "
             "print relative abundance",
             "coverm-tpu genome --coupled read1.fastq.gz read2.fastq.gz "
             "--genome-fasta-directory database/"),
            ("Calculate genome coverage from a pre-mapped BAM whose "
             "contigs are named genomeName~contigName",
             "coverm-tpu genome --bam-files my.bam --separator '~'"),
            ("Dereplicate genomes at 99% ANI before mapping",
             "coverm-tpu genome --genome-fasta-directory genomes/ "
             "--dereplicate --dereplication-ani 99 --single reads.fq.gz"),
        ],
        "contig": [
            ("Mean coverage of each contig from a sorted BAM",
             "coverm-tpu contig --bam-files my.bam"),
            ("Map paired reads to a reference and report trimmed mean",
             "coverm-tpu contig --reference ref.fna -1 r1.fq.gz -2 r2.fq.gz "
             "--methods trimmed_mean"),
            ("MetaBAT adjusted coverage table for binning",
             "coverm-tpu contig --bam-files s1.bam s2.bam --methods metabat "
             "> coverage.tsv"),
        ],
        "filter": [
            ("Keep alignments with at least 95% identity and half the "
             "read aligned",
             "coverm-tpu filter -b in.bam -o out.bam "
             "--min-read-percent-identity 95 --min-read-aligned-percent 50"),
            ("Extract reads that FAIL the thresholds",
             "coverm-tpu filter -b in.bam -o off_target.bam --inverse "
             "--min-read-percent-identity 95"),
        ],
        "make": [
            ("Map two samples against one reference, saving sorted BAMs",
             "coverm-tpu make -r ref.fna -1 a_1.fq b_1.fq -2 a_2.fq b_2.fq "
             "-o bams/"),
        ],
        "makedb": [
            ("Build a persistent minimap2 index from dereplicated genomes",
             "coverm-tpu makedb --genome-fasta-directory genomes/ "
             "--dereplicate -o db/ -p minimap2-sr"),
        ],
        "cluster": [
            ("Cluster genomes at 95% ANI and write the cluster table",
             "coverm-tpu cluster --genome-fasta-directory genomes/ "
             "--output-cluster-definition clusters.tsv"),
        ],
        "shell-completion": [
            ("Install bash completions for the current user",
             "coverm-tpu shell-completion --shell bash -o "
             "~/.bash_completion.d/coverm-tpu"),
        ],
    }
    for name, subp in parser._subparser_map.items():
        subp.description = subp.description or descriptions[name]
        ex = examples.get(name)
        if ex:
            subp._manpage_examples = ex
            subp._manpage_faq = faq
    return parser


class EstimatorsAndTaker:
    """Translate method flags into estimators, taker and printer
    (coverm.rs:1314-1504)."""

    def __init__(self, args, stream: OutputWriter):
        self.estimators = []
        self.columns_to_normalise = []
        self.rpkm_column = None
        self.tpm_column = None
        min_fraction_covered = parse_percentage(
            args.min_covered_fraction, "min-covered-fraction")
        ee = args.contig_end_exclusion
        methods = args.methods

        if "metabat" in methods:
            if len(methods) > 1:
                raise SystemExit(
                    "Cannot specify the metabat method with any other coverage methods")
            self.estimators = [
                LengthEstimator(),
                MeanEstimator(min_fraction_covered, ee, False),
                VarianceEstimator(min_fraction_covered, ee),
            ]
            self.taker = CachedCoverageTaker(len(self.estimators))
            self.printer = MetabatAdjustedCoveragePrinter()
            return

        for i, method in enumerate(methods):
            if method == "mean":
                self.estimators.append(MeanEstimator(min_fraction_covered, ee, False))
            elif method == "coverage_histogram":
                self.estimators.append(PileupCountsEstimator(min_fraction_covered, ee))
            elif method == "trimmed_mean":
                tmin = parse_percentage(args.trim_min, "trim-min")
                tmax = parse_percentage(args.trim_max, "trim-max")
                if tmin < 0 or tmin > 1 or tmax <= tmin or tmax > 1:
                    raise SystemExit(
                        f"error: Trim bounds must be between 0 and 1, and "
                        f"min must be less than max, found {tmin} and {tmax}")
                self.estimators.append(
                    TrimmedMeanEstimator(tmin, tmax, min_fraction_covered, ee))
            elif method == "covered_fraction":
                self.estimators.append(CoveredFractionEstimator(min_fraction_covered))
            elif method == "covered_bases":
                self.estimators.append(CoveredBasesEstimator(min_fraction_covered))
            elif method == "rpkm":
                if self.rpkm_column is not None:
                    raise SystemExit("The RPKM column cannot be specified more than once")
                self.rpkm_column = i
                self.estimators.append(RPKMEstimator(min_fraction_covered))
            elif method == "tpm":
                if self.tpm_column is not None:
                    raise SystemExit("The TPM column cannot be specified more than once")
                self.tpm_column = i
                self.estimators.append(TPMEstimator(min_fraction_covered))
            elif method == "variance":
                self.estimators.append(VarianceEstimator(min_fraction_covered, ee))
            elif method == "length":
                self.estimators.append(LengthEstimator())
            elif method == "relative_abundance":
                self.columns_to_normalise.append(i)
                self.estimators.append(MeanEstimator(min_fraction_covered, ee, False))
            elif method == "count":
                self.estimators.append(ReadCountEstimator())
            elif method == "reads_per_base":
                self.estimators.append(ReadsPerBaseEstimator())
            elif method == "anir":
                self.estimators.append(ANIrEstimator())
            elif method == "strobealign-aemb":
                if len(methods) > 1:
                    raise SystemExit(
                        "Cannot (currently) specify the strobealign-aemb method "
                        "with any other coverage methods")
                from .estimators import StrobealignAembEstimator
                self.estimators.append(StrobealignAembEstimator())
            else:
                raise SystemExit(f"Unknown method {method}")

        if "coverage_histogram" in methods:
            if len(methods) > 1:
                raise SystemExit(
                    "Cannot specify the coverage_histogram method with any "
                    "other coverage methods")
            self.taker = PileupCoverageTaker(stream)
            self.printer = StreamedCoveragePrinter()
        elif (not self.columns_to_normalise and self.rpkm_column is None
              and self.tpm_column is None and args.output_format == "sparse"):
            self.taker = StreamingCoverageTaker(stream)
            self.printer = StreamedCoveragePrinter()
        else:
            self.taker = CachedCoverageTaker(len(self.estimators))
            if args.output_format == "sparse":
                self.printer = SparseCachedCoveragePrinter()
            else:
                self.printer = DenseCachedCoveragePrinter()

        if min_fraction_covered != 0.0:
            bad = {
                ReadCountEstimator: "counts", LengthEstimator: "length",
                ReadsPerBaseEstimator: "reads_per_base", ANIrEstimator: "anir",
            }
            for e in self.estimators:
                for cls, name in bad.items():
                    if isinstance(e, cls):
                        raise SystemExit(
                            f"The '{name}' coverage estimator cannot be used "
                            "when --min-covered-fraction is > 0 as it does not "
                            "calculate the covered fraction. You may wish to "
                            "set the --min-covered-fraction to 0 and/or run "
                            "this estimator separately.")

    def print_headers(self, entry_type: str, stream: OutputWriter):
        headers = []
        for e in self.estimators:
            headers.extend(e.headers)
        for i in self.columns_to_normalise:
            headers[i] = "Relative Abundance (%)"
        self.printer.print_headers(entry_type, headers, stream)


def flag_filter_from_args(args) -> FlagFilter:
    return FlagFilter(
        include_improper_pairs=not args.proper_pairs_only,
        include_secondary=args.include_secondary,
        include_supplementary=not args.exclude_supplementary,
    )


def filter_params_from_args(args) -> FilterParams:
    return FilterParams(
        min_aligned_length_single=args.min_read_aligned_length,
        min_percent_identity_single=parse_percentage(
            args.min_read_percent_identity, "min-read-percent-identity"),
        min_aligned_percent_single=parse_percentage(
            args.min_read_aligned_percent, "min-read-aligned-percent"),
        min_mapq=args.min_mapq,
        min_aligned_length_pair=args.min_read_aligned_length_pair,
        min_percent_identity_pair=parse_percentage(
            args.min_read_percent_identity_pair, "min-read-percent-identity-pair"),
        min_aligned_percent_pair=parse_percentage(
            args.min_read_aligned_percent_pair, "min-read-aligned-percent-pair"),
    )


def main(argv=None, device=None):
    """The CLI. `device` (default: default_device(), so the card unless
    COVERM_TPU_TORCH_DEVICE=cpu) is where the coverage engine runs."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    # --full-help/--full-help-roff: man-page output per subcommand
    # (cli.rs:858-1366), intercepted pre-parse so required flags are moot
    if argv and argv[0] in parser._subparser_map and (
            "--full-help" in argv or "--full-help-roff" in argv):
        from .manpage import render_roff, render_text
        subp = parser._subparser_map[argv[0]]
        render = render_roff if "--full-help-roff" in argv else render_text
        print(render(subp, argv[0]))
        return 0
    args = parser.parse_args(argv)
    if args.subcommand is None:
        parser.print_help()
        return 1
    import logging
    level = logging.INFO
    if getattr(args, "quiet", False):
        level = logging.ERROR
    elif getattr(args, "verbose", False):
        level = logging.DEBUG
    logging.basicConfig(
        level=level,
        format="[%(asctime)s %(levelname)s] %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S")
    from . import commands
    from .device import resolve_device
    from .io.bam import BamFormatError
    from .scan import BamSortingError, MissingNMTagError
    if args.subcommand in ("filter", "make", "cluster", "makedb"):
        commands.unsupported(f"the {args.subcommand} subcommand")
    if args.subcommand == "shell-completion":
        return commands.run_shell_completion(args)
    if getattr(args, "profile_dir", None):
        commands.unsupported("--profile-dir")
    try:
        device = resolve_device(device)
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        raise SystemExit(1)
    try:
        if args.subcommand == "contig":
            return commands.run_contig(args, device)
        if args.subcommand == "genome":
            return commands.run_genome(args, device)
    except (BamSortingError, MissingNMTagError, BamFormatError,
            ValueError) as e:
        # fail-fast with the reference's message on stderr
        # (contig.rs:129-132, genome.rs:549-552, lib.rs:144-157)
        print(f"Error: {e}", file=sys.stderr)
        raise SystemExit(1)
    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
