"""CLI parity: `python -m coverm_tpu_torch` against `python -m coverm_tpu`.

Both packages run as subprocesses on the same in-repo BAMs, the JAX
package on the CPU (JAX_PLATFORMS=cpu, COVERM_TPU_PLATFORM=cpu) and the
port on the CPU by request (COVERM_TPU_TORCH_DEVICE=cpu). Standard
output must be byte-equal: contig and genome mode (separator,
definition file and genome FASTA files), dense and sparse output, the
streamed route (COVERM_TPU_STREAM_THRESHOLD=1) and the whole-file
route. For the
unsorted-BAM and missing-NM errors the exit code and the `Error:` line
on standard error must be equal. Each pair runs its two processes
side by side.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from coverm_tpu_torch.io import bgzf
from coverm_tpu_torch.io.sam import sam_text_to_bam_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMED = {"COVERM_TPU_STREAM_THRESHOLD": "1"}
WHOLE = {"COVERM_TPU_STREAM_THRESHOLD": str(1 << 40)}


def make_bam(path, n_contigs=7, contig_len=2500, n_reads=1500, seed=3,
             unsorted=False, drop_nm=False):
    """A copy of tests/test_single_device_prod.py's writer, with options
    for the two error fixtures."""
    rng = np.random.default_rng(seed)
    lens = np.full(n_contigs, contig_len)
    sam = [f"@SQ\tSN:g{i % 3}~c{i}\tLN:{lens[i]}" for i in range(n_contigs)]
    tids = np.sort(rng.integers(0, n_contigs, n_reads))
    starts = (rng.random(n_reads) * (lens[tids] - 120)).astype(int)
    order = np.lexsort((starts, tids))
    if unsorted:  # a read of the last contig moved to the front half
        order[n_reads // 3], order[-1] = order[-1], order[n_reads // 3]
    for j in order:
        nm = "" if (drop_nm and j % 11 == 0) else \
            f"\tNM:i:{int(rng.integers(0, 3))}"
        sam.append(
            f"r{j}\t0\tg{tids[j] % 3}~c{tids[j]}\t{starts[j] + 1}\t60\t100M"
            f"\t*\t0\t0\t{'A' * 100}\t*{nm}\tAS:i:100")
    with open(path, "wb") as f:
        w = bgzf.BgzfWriter(f)
        w.write(sam_text_to_bam_data(iter(sam)))
        w.close()
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    paths = {
        "a": make_bam(str(d / "a.bam")),
        # deeper, uneven sample with unobserved contigs
        "b": make_bam(str(d / "b.bam"), n_contigs=9, contig_len=4000,
                      n_reads=5000, seed=8),
        "unsorted": make_bam(str(d / "unsorted.bam"), unsorted=True),
        "no_nm": make_bam(str(d / "no_nm.bam"), drop_nm=True),
    }
    definition = d / "genomes.tsv"
    definition.write_text("".join(f"G{i % 2}\tg{i % 3}~c{i}\n"
                                  for i in range(7)))
    paths["def"] = str(definition)
    for g in range(3):  # genome FASTA files naming fixture "a"'s contigs
        fna = d / f"genome{g}.fna"
        fna.write_text("".join(f">g{g}~c{i}\n{'ACGT' * 625}\n"
                               for i in range(7) if i % 3 == g))
        paths[f"fna{g}"] = str(fna)
    return paths


def _run_pair(argv, env_extra):
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", COVERM_TPU_PLATFORM="cpu",
               COVERM_TPU_TORCH_DEVICE="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    env.update(env_extra)
    procs = [subprocess.Popen([sys.executable, "-m", pkg] + argv, cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for pkg in ("coverm_tpu", "coverm_tpu_torch")]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        out.append((p.returncode, stdout, stderr.decode()))
    return out


CASES = {
    "contig_dense_whole": (
        ["contig", "-b", "{a}", "{b}", "-m", "mean", "trimmed_mean",
         "variance", "covered_fraction", "covered_bases"], WHOLE),
    "contig_dense_streamed": (
        ["contig", "-b", "{a}", "{b}", "-m", "mean", "trimmed_mean",
         "variance", "covered_fraction", "covered_bases"], STREAMED),
    "contig_sparse_counts_streamed": (
        ["contig", "-b", "{a}", "{b}", "--output-format", "sparse", "-m",
         "rpkm", "tpm", "count", "reads_per_base", "length"], STREAMED),
    "contig_histogram_streamed": (
        ["contig", "-b", "{b}", "-m", "coverage_histogram"], STREAMED),
    "contig_metabat_whole": (
        ["contig", "-b", "{a}", "{b}", "-m", "metabat"], WHOLE),
    "genome_separator_whole": (
        ["genome", "-s", "~", "-b", "{a}", "{b}", "-m", "relative_abundance",
         "mean", "trimmed_mean", "variance", "covered_fraction", "rpkm",
         "tpm"], WHOLE),
    "genome_separator_sparse_streamed": (
        ["genome", "-s", "~", "-b", "{b}", "--output-format", "sparse",
         "--min-covered-fraction", "0", "-m", "count", "reads_per_base",
         "covered_bases", "mean"], STREAMED),
    "genome_definition_streamed": (
        ["genome", "--genome-definition", "{def}", "-b", "{a}", "-m",
         "relative_abundance", "mean", "variance", "covered_fraction"],
        STREAMED),
    "genome_fasta_files_whole": (
        ["genome", "-f", "{fna0}", "{fna1}", "{fna2}", "-b", "{a}", "-m",
         "relative_abundance", "mean", "covered_fraction"], WHOLE),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stdout_byte_equal(data, case):
    argv, env_extra = CASES[case]
    argv = [a.format(**data) for a in argv]
    (rc_j, out_j, err_j), (rc_t, out_t, err_t) = _run_pair(argv, env_extra)
    assert rc_j == 0, err_j
    assert rc_t == 0, err_t
    assert out_j.count(b"\n") >= 2
    assert out_t == out_j


@pytest.mark.parametrize("kind,route", [("unsorted", STREAMED),
                                        ("no_nm", WHOLE)])
def test_errors_equal(data, kind, route):
    argv = ["contig", "-b", data[kind], "-m", "mean"]
    (rc_j, out_j, err_j), (rc_t, out_t, err_t) = _run_pair(argv, route)
    assert rc_j != 0
    assert rc_t == rc_j

    def error_line(err):
        return [line for line in err.splitlines()
                if line.startswith("Error:")]

    assert error_line(err_j), err_j
    assert error_line(err_t) == error_line(err_j)
    assert out_t == out_j
