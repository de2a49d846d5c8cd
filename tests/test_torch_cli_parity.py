"""CLI parity: `python -m coverm_tpu_torch` against `python -m coverm_tpu`.

Both packages run as subprocesses on the same in-repo BAMs, the JAX
package on the CPU (JAX_PLATFORMS=cpu, COVERM_TPU_PLATFORM=cpu) and the
port on the CPU by request (COVERM_TPU_TORCH_DEVICE=cpu). Standard
output must be byte-equal: contig and genome mode (separator,
definition file and genome FASTA files), dense and sparse output, the
streamed route (COVERM_TPU_STREAM_THRESHOLD=1) and the whole-file
route, and the read filters streamed in 16 KiB segments (metabat's
preset and --min-read-* on the port's fused scan, a pair filter and
COVERM_TPU_FUSED=0 on its classic reader, metabat over a two-device
mesh). For the unsorted-BAM (also under metabat's preset) and
missing-NM errors the exit code and the `Error:` line on standard error
must be equal. With `--profile-dir` the TSV must equal
the JAX package's and the port's own without the option, and each
package must write a trace. Each pair runs its two processes side by
side.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from coverm_tpu_torch.io import bgzf
from coverm_tpu_torch.io.sam import sam_text_to_bam_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMED = {"COVERM_TPU_STREAM_THRESHOLD": "1"}
WHOLE = {"COVERM_TPU_STREAM_THRESHOLD": str(1 << 40)}
# streamed in segments of 16 KiB, so that a sample spans several
SEGMENTED = {**STREAMED, "COVERM_TPU_SEGMENT_BYTES": str(1 << 14)}


def make_bam(path, n_contigs=7, contig_len=2500, n_reads=1500, seed=3,
             unsorted=False, drop_nm=False, nm_hi=3, paired=False):
    """A copy of tests/test_single_device_prod.py's writer, with options
    for the two error fixtures, for NM drawn from 0..nm_hi - 1 (the read
    filters' fixtures: NM 3 of 100 is below 97% identity) and for
    consecutive reads as proper pairs."""
    rng = np.random.default_rng(seed)
    lens = np.full(n_contigs, contig_len)
    sam = [f"@SQ\tSN:g{i % 3}~c{i}\tLN:{lens[i]}" for i in range(n_contigs)]
    tids = np.sort(rng.integers(0, n_contigs, n_reads))
    starts = (rng.random(n_reads) * (lens[tids] - 120)).astype(int)
    order = np.lexsort((starts, tids))
    if unsorted:  # a read of the last contig moved to the front half
        order[n_reads // 3], order[-1] = order[-1], order[n_reads // 3]
    for rank, j in enumerate(order):
        nm = "" if (drop_nm and j % 11 == 0) else \
            f"\tNM:i:{int(rng.integers(0, nm_hi))}"
        name, flag, mate = f"r{j}", 0, "*\t0"
        if paired:
            name, flag = f"p{rank // 2}", (99, 147)[rank % 2]
            mate = f"=\t{starts[j] + 1}"
        sam.append(
            f"{name}\t{flag}\tg{tids[j] % 3}~c{tids[j]}\t{starts[j] + 1}\t60"
            f"\t100M\t{mate}\t0\t{'A' * 100}\t*{nm}\tAS:i:100")
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
        # NM 0-6 of 100: the read filters keep some reads and drop others
        "f": make_bam(str(d / "f.bam"), n_contigs=9, contig_len=4000,
                      n_reads=5000, seed=11, nm_hi=7),
        "pairs": make_bam(str(d / "pairs.bam"), n_contigs=9,
                          contig_len=4000, n_reads=5000, seed=12, nm_hi=7,
                          paired=True),
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


def run_both(argvs, env_extra=None, cwds=(REPO, REPO), path_dir=None):
    """Run `python -m coverm_tpu` and `python -m coverm_tpu_torch` side by
    side, each with its own argv and working directory, both on the CPU
    (path_dir first on PATH); [(returncode, stdout, stderr)] in that
    order."""
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", COVERM_TPU_PLATFORM="cpu",
               COVERM_TPU_TORCH_DEVICE="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=REPO)
    if path_dir:
        env["PATH"] = f"{path_dir}:{os.environ['PATH']}"
    env.update(env_extra or {})
    procs = [subprocess.Popen([sys.executable, "-m", pkg] + argv, cwd=cwd,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for pkg, argv, cwd in zip(("coverm_tpu", "coverm_tpu_torch"),
                                       argvs, cwds)]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        out.append((p.returncode, stdout, stderr.decode()))
    return out


# standard error lines that are not the program's own: log records with
# their timestamps, and the notes of the XLA and profiler runtimes
_NOISE = re.compile(r"^(\[\d{4}-\d\d-\d\dT|[EWI]\d{4} |USDT:|WARNING: All log)")


def outcome(result, cwd, traces=()):
    """(returncode, stdout, message, files) of one run_both result. The
    message is the last line of standard error when the run failed, else
    its lines that are neither log records nor runtime notes, with the
    package's name made common. files maps every path written under cwd
    to its bytes (None for a directory); a directory named in `traces`
    (a profiler trace, whose format is each package's own) maps only to
    whether it holds a file."""
    rc, stdout, stderr = result
    lines = [l for l in stderr.splitlines()
             if l.strip() and not _NOISE.match(l)]
    message = lines[-1:] if rc != 0 else lines
    message = [l.replace("coverm_tpu_torch", "coverm_tpu") for l in message]
    files = {}
    for root, dirs, names in os.walk(cwd):
        rel = os.path.relpath(root, cwd)
        top = rel.split(os.sep)[0]
        if top in traces:
            files[top] = files.get(top, False) or bool(names)
            continue
        for d in dirs:
            if os.path.normpath(os.path.join(rel, d)) not in traces:
                files[os.path.normpath(os.path.join(rel, d))] = None
        for n in names:
            with open(os.path.join(root, n), "rb") as f:
                files[os.path.normpath(os.path.join(rel, n))] = f.read()
    return rc, stdout, message, files


def _run_pair(argv, env_extra):
    return run_both([argv, argv], env_extra)


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
    # the single-read filter inside the port's fused scan (the JAX package
    # filters the classic batches)
    "contig_metabat_streamed": (
        ["contig", "-b", "{f}", "{a}", "-m", "metabat"], SEGMENTED),
    "genome_separator_min_read_streamed": (
        ["genome", "-s", "~", "-b", "{f}", "--min-read-percent-identity",
         "96", "--min-read-aligned-length", "50",
         "--min-read-aligned-percent", "90", "-m", "relative_abundance",
         "mean", "covered_fraction", "rpkm"], SEGMENTED),
    # a pair filter, and COVERM_TPU_FUSED=0, keep the port's classic reader
    "contig_pair_filter_streamed": (
        ["contig", "-b", "{pairs}", "--min-read-percent-identity-pair", "96",
         "-m", "mean", "count", "covered_fraction"], SEGMENTED),
    "contig_metabat_classic_streamed": (
        ["contig", "-b", "{f}", "-m", "metabat"],
        {**SEGMENTED, "COVERM_TPU_FUSED": "0"}),
    # the filtered fused scan with the mesh depth_fn over two devices
    "contig_metabat_mesh1_streamed": (
        ["contig", "-b", "{f}", "-m", "metabat"],
        {**SEGMENTED, "COVERM_TPU_MESH": "1",
         "COVERM_TPU_TORCH_CPU_DEVICES": "2",
         "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}),
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


def test_metabat_unsorted_error_equal(data):
    """An unsorted BAM under metabat's filter preset, streamed: the
    port's fused filtered scan refuses it as the JAX package's classic
    route does."""
    argv = ["contig", "-b", data["unsorted"], "-m", "metabat"]
    (rc_j, out_j, err_j), (rc_t, out_t, err_t) = _run_pair(argv, SEGMENTED)
    assert rc_j != 0
    assert rc_t == rc_j
    errors = [[line for line in err.splitlines() if line.startswith("Error:")]
              for err in (err_j, err_t)]
    assert errors[0] and "unsorted" in errors[0][0], err_j
    assert errors[1] == errors[0]
    assert out_t == out_j


@pytest.mark.parametrize("argv", [
    ["contig", "-b", "{a}", "{b}", "-m", "mean", "trimmed_mean",
     "covered_fraction"],
    ["genome", "-s", "~", "-b", "{a}", "-m", "relative_abundance", "mean",
     "variance"],
])
def test_profile_dir_equals_jax_and_the_run_without(data, tmp_path, argv):
    """--profile-dir: the TSV equals the JAX package's and the port's run
    without it, and each package writes its trace into the directory."""
    argv = [a.format(**data) for a in argv]
    cwds = [tmp_path / "jax", tmp_path / "torch"]
    for c in cwds:
        c.mkdir()
    results = run_both([argv + ["--profile-dir", "p"]] * 2, WHOLE, cwds=cwds)
    want, got = (outcome(r, c, traces=("p",)) for r, c in zip(results, cwds))
    assert got == want
    assert want[0] == 0 and want[3] == {"p": True}
    traces = [f for f in os.listdir(cwds[1] / "p")
              if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    plain = run_both([argv, argv], WHOLE)[1]
    assert plain[0] == 0 and plain[1] == got[1]
