"""Per-gene coverage (`--gff`, coverm_tpu_torch/genes.py) against the JAX
package, on the CPU.

The BAMs and GFFs are written here: genes that overlap their neighbours,
genes that run past the contig end, genes on contigs absent from the
header, two feature types, GFF and GTF-style attributes and a gene with
no identifier. `python -m coverm_tpu_torch` must print the JAX package's
standard output byte for byte in contig mode and in genome mode (with a
separator, a definition file and --single-genome), for the histogram
methods, for more than 65,536 genes, which takes the sweep's dense
remap, and under a single-read filter on the streamed route. A gene spanning a whole contig must give the contig's mean.
"""

import numpy as np
import pytest

from coverm_tpu_torch.cli import main
from coverm_tpu_torch.io import bgzf
from coverm_tpu_torch.io.sam import sam_text_to_bam_data
from coverm_tpu_torch.ops.sweep import DENSE_REMAP_THRESHOLD

from test_torch_cli_parity import STREAMED, WHOLE, _run_pair

LENGTHS = [3000, 5000, 2200, 4100, 6000, 1500]
NAMES = [f"g{i % 3}~c{i}" for i in range(len(LENGTHS))]


def write_bam(path, lengths=LENGTHS, names=NAMES, n_reads=2500, seed=0,
              read_len=100):
    """Coordinate-sorted BAM with mixed flags and CIGARs; the last
    contig gets no reads."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lengths)
    sam = [f"@SQ\tSN:{n}\tLN:{ln}" for n, ln in zip(names, lengths)]
    tids = np.sort(rng.integers(0, len(lengths) - 1, n_reads))
    starts = (rng.random(n_reads) * (lens[tids] - 40)).astype(int)
    order = np.lexsort((starts, tids))
    cigars = [f"{read_len}M", f"10S{read_len - 10}M",
              f"40M2I{read_len - 42}M", f"50M3D{read_len - 50}M"]
    flags = [0, 0, 0, 16, 256, 2048, 0, 1024]
    for j in order:
        sam.append(
            f"r{j}\t{flags[j % len(flags)]}\t{names[tids[j]]}\t"
            f"{starts[j] + 1}\t60\t{cigars[j % len(cigars)]}\t*\t0\t0\t"
            f"{'ACGT' * (read_len // 4)}\t*\tNM:i:{j % 4}\tAS:i:90")
    with open(path, "wb") as f:
        w = bgzf.BgzfWriter(f)
        w.write(sam_text_to_bam_data(iter(sam)))
        w.close()
    return path


def write_gff(path):
    """Genes of 250 bp every 300 bp, every fifth stretched over its
    neighbour; genes past the contig end; unknown contigs; CDS features
    beside the genes; GFF and GTF attributes; one gene with no ID."""
    rows = ["##gff-version 3"]
    k = 0
    for name, ln in zip(NAMES, LENGTHS):
        for s in range(0, ln + 400, 300):
            k += 1
            e = s + 250 + (200 if k % 5 == 0 else 0)
            attr = (f"ID=gene{k}" if k % 7 else f'gene_id "gtf{k}"; x "y"')
            if k % 29 == 0:
                attr = "note=anonymous"
            rows.append(f"{name}\tsrc\tgene\t{s + 1}\t{e}\t.\t+\t.\t{attr}")
            if k % 3 == 0:
                rows.append(f"{name}\tsrc\tCDS\t{s + 11}\t{e - 10}\t.\t+\t0"
                            f"\tID=cds{k};Parent=gene{k}")
    for j in range(3):
        rows.append(f"absent{j}\tsrc\tgene\t1\t500\t.\t+\t.\tID=lost{j}")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("genes")
    paths = {"a": write_bam(str(d / "a.bam")),
             "b": write_bam(str(d / "b.bam"), n_reads=4000, seed=5),
             "gff": write_gff(str(d / "genes.gff"))}
    definition = d / "genomes.tsv"
    definition.write_text("".join(f"G{i % 2}\t{n}\n"
                                  for i, n in enumerate(NAMES[:-1])))
    paths["def"] = str(definition)
    # more genes than DENSE_REMAP_THRESHOLD: 10 bp genes tiling two
    # 400 kbp contigs, at a depth of about 0.2
    n_tiny = 2 * 400_000 // 10
    assert n_tiny > DENSE_REMAP_THRESHOLD
    tiny_names = ["t~a", "t~b"]
    paths["tiny_bam"] = write_bam(str(d / "tiny.bam"), [400_000] * 3,
                                  tiny_names + ["t~c"], n_reads=1600,
                                  seed=2)
    with open(d / "tiny.gff", "w") as f:
        for name in tiny_names:
            for s in range(0, 400_000, 10):
                f.write(f"{name}\tsrc\tgene\t{s + 1}\t{s + 10}\t.\t+\t.\t"
                        f"ID={name}_{s}\n")
    paths["tiny_gff"] = str(d / "tiny.gff")
    return paths


M_STATS = ["mean", "trimmed_mean", "variance", "covered_fraction"]
CASES = {
    "contig_stats_streamed": (
        ["contig", "--gff", "{gff}", "-b", "{a}", "{b}", "-m", *M_STATS],
        STREAMED),
    "contig_counts_feature_type_whole": (
        ["contig", "--gff", "{gff}", "--gff-feature-type", "CDS", "-b",
         "{a}", "-m", "count", "covered_bases", "length", "rpkm", "tpm",
         "reads_per_base"], WHOLE),
    "contig_histogram_streamed": (
        ["contig", "--gff", "{gff}", "-b", "{b}", "-m",
         "coverage_histogram"], STREAMED),
    "contig_no_zeros_sparse_whole": (
        ["contig", "--gff", "{gff}", "-b", "{a}", "--no-zeros",
         "--output-format", "sparse", "-m", "mean", "anir",
         "--contig-end-exclusion", "0"], WHOLE),
    "genome_separator_streamed": (
        ["genome", "--gff", "{gff}", "-s", "~", "-b", "{a}", "{b}",
         "--min-covered-fraction", "0", "-m", "mean", "covered_fraction",
         "count", "variance"], STREAMED),
    "genome_definition_whole": (
        ["genome", "--gff", "{gff}", "--genome-definition", "{def}", "-b",
         "{a}", "-m", "mean", "trimmed_mean", "relative_abundance"], WHOLE),
    "genome_single_genome_streamed": (
        ["genome", "--gff", "{gff}", "--single-genome", "-b", "{b}", "-m",
         "mean", "covered_bases"], STREAMED),
    # a filtered source's stream read by the gene route: the classic
    # batches through the read filter
    "contig_min_read_identity_streamed": (
        ["contig", "--gff", "{gff}", "-b", "{a}", "{b}",
         "--min-read-percent-identity", "97.5", "-m", "mean", "count",
         "covered_fraction"], STREAMED),
    "contig_dense_remap_streamed": (
        ["contig", "--gff", "{tiny_gff}", "-b", "{tiny_bam}", "-m", "mean",
         "count", "covered_fraction"], STREAMED),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stdout_byte_equal(data, case):
    argv, env = CASES[case]
    argv = [a.format(**data) for a in argv]
    (rc_j, out_j, err_j), (rc_t, out_t, err_t) = _run_pair(argv, env)
    assert rc_j == 0, err_j
    assert rc_t == 0, err_t
    assert out_j.count(b"\n") >= 10
    assert out_t == out_j


def test_whole_contig_gene_equals_contig_mean(data, tmp_path, capsys):
    """A gene spanning a whole contig gives the contig-mode mean."""
    gff = tmp_path / "whole.gff"
    gff.write_text("".join(f"{n}\tt\tgene\t1\t{ln}\t.\t+\t.\tID=w{i}\n"
                           for i, (n, ln) in enumerate(zip(NAMES, LENGTHS))))
    common = ["-b", data["a"], "-m", "mean", "--contig-end-exclusion", "0",
              "--output-format", "sparse"]
    assert main(["contig", "--gff", str(gff), *common], device="cpu") == 0
    out_gene = capsys.readouterr().out
    assert main(["contig", *common], device="cpu") == 0
    out_contig = capsys.readouterr().out
    gene_vals = [l.split("\t")[-1] for l in out_gene.strip().split("\n")[1:]]
    contig_vals = [l.split("\t")[-1]
                   for l in out_contig.strip().split("\n")[1:]]
    assert len(gene_vals) == len(NAMES)
    assert gene_vals == contig_vals
