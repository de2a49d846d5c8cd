"""`cluster`, `genome --dereplicate` and the CheckM filter of the port
(coverm_tpu_torch/derep.py, commands.checkm_filter_genomes,
run_cluster, run_genome) against the JAX package, on the CPU.

The fixture (seed 11) holds five genome FASTAs: `ga`, `gb` (ga with 1% of
its bases changed), `gd` (0.5%), `gc` (unrelated) and `ge` (three
contigs, two of them near copies), quality tables in the CheckM tab,
CheckM2 report and dRep genome-info formats, a reference-genomes list,
fake skani and fastANI executables reading a fixed ANI table (built as
tests/test_derep_external_ani.py builds them), and a sorted BAM of reads
over every contig. Both packages run side by side in their own
directories. Exit status, standard output, the message on standard
error, and every file written (cluster definitions, representative
lists, the representative FASTA directories) must be byte-equal; the
genome TSVs too. With `--cluster-contigs` the per-contig FASTAs live in
a fresh temporary directory of each run, whose name is made common
before the comparison.
"""

import re
import stat
import sys

import numpy as np
import pytest

from coverm_tpu_torch.io import bgzf
from coverm_tpu_torch.io.sam import sam_text_to_bam_data

from test_derep import mutate, random_seq
from test_derep_external_ani import FAKE_FASTANI, FAKE_SKANI
from test_torch_cli_parity import outcome, run_both

GENOMES = ("ga", "gb", "gc", "gd", "ge")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("derep")
    rng = np.random.default_rng(11)
    base = random_seq(rng, 40000)
    other = random_seq(rng, 30000)
    seqs = {"ga": [base], "gb": [mutate(rng, base, 0.01)], "gc": [other],
            "gd": [mutate(rng, base, 0.005)]}
    e1 = random_seq(rng, 12000)
    seqs["ge"] = [e1, mutate(rng, e1, 0.002), random_seq(rng, 9000)]
    gdir = d / "genomes"
    gdir.mkdir()
    paths, contigs = {}, []
    for g in GENOMES:
        p = gdir / f"{g}.fna"
        p.write_text("".join(f">{g}_{i} contig {i} of {g}\n{s}\n"
                             for i, s in enumerate(seqs[g])))
        paths[g] = str(p)
        contigs += [(f"{g}_{i}", len(s)) for i, s in enumerate(seqs[g])]
    paths["gdir"] = str(gdir)
    paths["all"] = " ".join(paths[g] for g in GENOMES)

    quality = {"ga": (95.0, 1.0), "gb": (99.0, 0.5), "gc": (55.0, 2.0),
               "gd": (97.0, 8.0), "ge": (80.0, 3.0)}
    tab = d / "checkm.tsv"
    tab.write_text("Bin Id\tMarker lineage\tCompleteness\tContamination\n"
                   + "".join(f"{g}\tk__Bacteria\t{c}\t{x}\n"
                             for g, (c, x) in quality.items()))
    report = d / "quality_report.tsv"
    report.write_text("Name\tCompleteness\tContamination\n"
                      + "".join(f"{g}\t{c}\t{x}\n"
                                for g, (c, x) in quality.items()))
    info = d / "genomeInfo.csv"
    info.write_text("genome,completeness,contamination\n"
                    + "".join(f"{g}.fna,{c},{x}\n"
                              for g, (c, x) in quality.items()))
    refs = d / "refs.txt"
    refs.write_text(paths["gd"] + "\n")
    paths.update(tab=str(tab), report=str(report), info=str(info),
                 refs=str(refs))

    bindir = d / "bin"
    bindir.mkdir()
    for name, body in (("skani", FAKE_SKANI), ("fastANI", FAKE_FASTANI)):
        exe = bindir / name
        exe.write_text(body.format(py=sys.executable))
        exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    paths["bindir"] = str(bindir)
    table = d / "ani_table.tsv"
    table.write_text("".join(f"{paths[g]}\t{ani}\t{af}\n" for g, ani, af in (
        ("gb", 96.5, 0.8), ("gd", 99.0, 0.9), ("gc", 93.0, 0.9),
        ("ge", 96.0, 0.05))))
    paths["table"] = str(table)

    sam = [f"@SQ\tSN:{c}\tLN:{ln}" for c, ln in contigs]
    for tid, (c, ln) in enumerate(contigs):
        starts = np.sort(rng.integers(0, ln - 100, ln // 40))
        sam += [f"r{tid}_{k}\t0\t{c}\t{s + 1}\t60\t100M\t*\t0\t0\t"
                f"{'A' * 100}\t*\tNM:i:{int(rng.integers(0, 4))}"
                for k, s in enumerate(starts)]
    paths["bam"] = str(d / "reads.bam")
    with open(paths["bam"], "wb") as f:
        w = bgzf.BgzfWriter(f)
        w.write(sam_text_to_bam_data(iter(sam)))
        w.close()
    return paths


OUTPUTS = ["--output-cluster-definition", "clusters.tsv",
           "--output-representative-list", "reps.txt",
           "--output-representative-fasta-directory", "repdir",
           "--output-representative-fasta-directory-copy", "repcopy"]

CLUSTER = {
    "sketch_stdout": ["--cluster-method", "sketch"],
    "sketch_outputs": ["--cluster-method", "sketch", "--ani", "99.2",
                       *OUTPUTS],
    "checkm_tab_min_completeness": [
        "--cluster-method", "sketch", "--checkm-tab-table", "{tab}",
        "--min-completeness", "60", *OUTPUTS],
    "checkm2_report_max_contamination": [
        "--cluster-method", "sketch", "--checkm2-quality-report",
        "{report}", "--max-contamination", "5", *OUTPUTS],
    "genome_info_quality_formula": [
        "--cluster-method", "sketch", "--genome-info", "{info}",
        "--quality-formula", "completeness-5contamination", *OUTPUTS],
    "reference_genomes_list": [
        "--cluster-method", "sketch", "--reference-genomes-list", "{refs}",
        *OUTPUTS],
    "cluster_contigs": ["--cluster-method", "sketch", "--cluster-contigs",
                        "--ani", "99", *OUTPUTS],
    "fake_skani": ["--cluster-method", "skani", "--checkm-tab-table",
                   "{tab}", *OUTPUTS],
    "fake_fastani": ["--cluster-method", "fastani", "--ani", "97",
                     "--output-cluster-definition", "clusters.tsv"],
    "skani_missing": ["--cluster-method", "skani"],
    "genome_without_quality_row": [
        "--cluster-method", "sketch", "--checkm-tab-table", "{tab}",
        "--min-completeness", "10", "-f", "{ga}", "{gc}", "{refs}"],
}

_TMP = re.compile(rb"coverm-tpu-contigs[^/\s]*")


def _run(data, tmp_path, argv, path_dir=None):
    cwds = [tmp_path / "jax", tmp_path / "torch"]
    for c in cwds:
        c.mkdir()
    env = {"FAKE_ANI_TABLE": data["table"]}
    results = run_both([argv, argv], env, cwds=cwds, path_dir=path_dir)
    out = []
    for r, c in zip(results, cwds):
        rc, stdout, message, files = outcome(r, c)
        files = {k: None if v is None else _TMP.sub(b"TMP", v)
                 for k, v in files.items()}
        out.append((rc, _TMP.sub(b"TMP", stdout), message, files))
    return out


@pytest.mark.parametrize("case", list(CLUSTER))
def test_cluster_equals_jax(data, tmp_path, case):
    args = [a.format(**data) for a in CLUSTER[case]]
    if "-f" not in args:
        args = ["-f", *data["all"].split()] + args
    path_dir = None if case == "skani_missing" else data["bindir"]
    want, got = _run(data, tmp_path, ["cluster", *args], path_dir)
    assert got == want
    rc, stdout, message, files = want
    if case in ("skani_missing", "genome_without_quality_row"):
        assert rc != 0 and message, want
        return
    assert rc == 0, want
    assert re.fullmatch(r"Found \d+ cluster representatives", message[-1])
    assert stdout or files["clusters.tsv"]


GENOME = {
    "dereplicate_sketch": [
        "--dereplicate", "--dereplication-cluster-method", "sketch",
        "--dereplication-output-cluster-definition", "clusters.tsv",
        "--dereplication-output-representative-list", "reps.txt"],
    "dereplicate_directory_checkm2": [
        "-d", "{gdir}", "-x", "fna", "--dereplicate",
        "--dereplication-cluster-method", "sketch",
        "--checkm2-quality-report", "{report}", "--dereplication-ani", "99"],
    "dereplicate_fake_fastani": [
        "--dereplicate", "--dereplication-cluster-method", "fastani",
        "--dereplication-ani", "97", "--dereplication-output-cluster-"
        "definition", "clusters.tsv"],
    "checkm_min_completeness": ["--checkm-tab-table", "{tab}",
                                "--min-completeness", "60"],
    "genome_info_max_contamination": ["--genome-info", "{info}",
                                      "--max-contamination", "5"],
    "checkm_removes_every_genome": ["--checkm-tab-table", "{tab}",
                                    "--min-completeness", "99.5"],
}


@pytest.mark.parametrize("case", list(GENOME))
def test_genome_dereplicate_and_checkm_equal_jax(data, tmp_path, case):
    args = [a.format(**data) for a in GENOME[case]]
    if "-d" not in args:
        args = ["-f", *data["all"].split()] + args
    argv = ["genome", "-b", data["bam"], *args, "-m", "relative_abundance",
            "mean", "covered_fraction", "--min-covered-fraction", "0"]
    want, got = _run(data, tmp_path, argv, data["bindir"])
    assert got == want
    rc, stdout, message, _files = want
    if case == "checkm_removes_every_genome":
        assert rc != 0 and message, want
        return
    assert rc == 0, want
    assert stdout.startswith(b"Genome\t") and stdout.count(b"\n") >= 3

