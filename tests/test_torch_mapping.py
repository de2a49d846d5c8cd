"""Mapping from reads, `make`, `--sharded` and `-m strobealign-aemb` of
the port (coverm_tpu_torch/mapping/, shard.py) against the JAX package,
on the CPU.

No mapper ships with this repository, so tests/fake_mapper.py (exact
substring search, SAM on standard output) is installed on PATH under the
mappers' names, as tests/test_mapping_e2e.py does. Both packages run as
subprocesses side by side; standard output must be byte-equal for
contig and genome mode from paired, coupled, interleaved and single
reads, with inline filtering, the BAM caches, the spilled external sort,
`--sharded` from reads and from name-sorted shard BAMs (in memory and
streamed, with --exclude-genomes-from-deshard), and strobealign-aemb.
`make` must write the same records. `filter`, `cluster`, `makedb`,
`--profile-dir`, `--dereplicate` and the CheckM filter give the same
outcome as the JAX package's.
"""

import os
import stat
import subprocess
import sys

import numpy as np
import pytest

from coverm_tpu_torch.io import bgzf
from coverm_tpu_torch.io.bam import BamReader
from coverm_tpu_torch.io.sam import sam_text_to_bam_data
from coverm_tpu_torch.mapping.pipeline import SamStreamConsumer

from test_torch_cli_parity import REPO, STREAMED, WHOLE, outcome, run_both

HERE = os.path.dirname(os.path.abspath(__file__))
READ_LEN = 100


def _seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _fastq(path, reads):
    with open(path, "w") as f:
        f.write("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads))
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three contigs in two genome FASTAs (and their concatenation as one
    reference), and reads sampled from them: pairs, singles, reads with
    mismatches (`_nmK` names) and reads that match nothing."""
    d = tmp_path_factory.mktemp("mapping")
    rng = np.random.default_rng(9)
    contigs = {"c1": _seq(rng, 1500), "c2": _seq(rng, 1100),
               "c3": _seq(rng, 900)}
    paths = {}
    genomes = {"gA": ["c1", "c2"], "gB": ["c3"]}
    os.makedirs(d / "genomes")
    for g, cs in genomes.items():
        p = d / "genomes" / f"{g}.fna"
        p.write_text("".join(f">{c}\n{contigs[c]}\n" for c in cs))
        paths[g] = str(p)
    paths["gdir"] = str(d / "genomes")
    ref = d / "ref.fna"
    ref.write_text("".join(f">{c}\n{s}\n" for c, s in contigs.items()))
    paths["ref"] = str(ref)
    # second reference for --sharded: c3 again (ties) and a new contig
    paths["ref2"] = str(d / "ref2.fna")
    c4 = _seq(rng, 1200)
    with open(paths["ref2"], "w") as f:
        f.write(f">c3b\n{contigs['c3']}\n>c4\n{c4}\n")
    allc = dict(contigs, c4=c4)

    def sample(name, tag=""):
        c = list(allc)[int(rng.integers(0, len(allc)))]
        s = int(rng.integers(0, len(allc[c]) - 2 * READ_LEN))
        return name + tag, allc[c][s:s + READ_LEN], allc[c][
            s + READ_LEN:s + 2 * READ_LEN]

    r1, r2, single = [], [], []
    for i in range(160):
        tag = f"_nm{i % 4}" if i % 5 == 0 else ""
        n, a, b = sample(f"p{i:04d}", tag)
        if i % 23 == 0:
            a = _seq(rng, READ_LEN)          # mate that maps nowhere
        r1.append((n, a))
        r2.append((n, b))
    for i in range(120):
        n, a, _b = sample(f"s{i:04d}", f"_nm{i % 6}" if i % 4 == 0 else "")
        single.append((n, a))
    single.append(("junk", _seq(rng, READ_LEN)))
    paths["r1"] = _fastq(d / "r1.fq", r1)
    paths["r2"] = _fastq(d / "r2.fq", r2)
    paths["single"] = _fastq(d / "single.fq", single)
    inter = [x for pair in zip(r1, r2) for x in pair]
    paths["inter"] = _fastq(d / "inter.fq", inter)

    bindir = d / "fakebin"
    bindir.mkdir()
    with open(os.path.join(HERE, "fake_mapper.py")) as f:
        body = f.read().split("\n", 1)[1]
    for name in ("minimap2", "strobealign", "bwa", "bwa-mem2"):
        dst = bindir / name
        dst.write_text(f"#!{sys.executable}\n" + body)
        dst.chmod(dst.stat().st_mode | stat.S_IEXEC)
    paths["bindir"] = str(bindir)

    write_shards(paths, d, rng)
    excl = d / "exclude.txt"
    excl.write_text("B1\n")
    paths["exclude"] = str(excl)
    return paths


def write_shards(paths, d, rng, n_pairs=400):
    """Two read-name-sorted, paired shard BAMs over the same read set,
    against references `A~*` and `B~*`: each pair maps to one contig of a
    shard (both mates, AS scores), or is unmapped there."""
    shards = {"s1": (["A0~x", "A1~y"], [4000, 3000]),
              "s2": (["B0~z", "B1~w", "B2~v"], [3500, 2500, 5000])}
    for key, (names, lens) in shards.items():
        sam = [f"@SQ\tSN:{n}\tLN:{ln}" for n, ln in zip(names, lens)]
        for k in range(n_pairs):
            q = f"q{k:05d}"
            if rng.random() < 0.25:
                for flag in (77, 141):
                    sam.append(f"{q}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t"
                               f"{'A' * 80}\t*")
                continue
            t = int(rng.integers(0, len(names)))
            p1 = int(rng.integers(1, lens[t] - 300))
            p2 = p1 + int(rng.integers(0, 200))
            nm1, nm2 = (int(x) for x in rng.integers(0, 4, 2))
            as1, as2 = 80 - nm1 - int(rng.integers(0, 3)), 80 - nm2
            sam.append(f"{q}\t99\t{names[t]}\t{p1}\t60\t80M\t=\t{p2}\t0\t"
                       f"{'A' * 80}\t*\tNM:i:{nm1}\tAS:i:{as1}")
            sam.append(f"{q}\t147\t{names[t]}\t{p2}\t60\t80M\t=\t{p1}\t0\t"
                       f"{'C' * 80}\t*\tNM:i:{nm2}\tAS:i:{as2}")
        path = str(d / f"{key}.bam")
        with open(path, "wb") as f:
            w = bgzf.BgzfWriter(f)
            w.write(sam_text_to_bam_data(iter(sam)))
            w.close()
        paths[key] = path


SPILL = {"COVERM_TPU_MAPPER_SPILL_BYTES": "2000"}
CASES = {
    "contig_paired": (
        ["contig", "-r", "{ref}", "-1", "{r1}", "-2", "{r2}", "-m", "mean",
         "trimmed_mean", "variance", "covered_fraction", "count"], {}),
    "contig_coupled_minimap2": (
        ["contig", "-r", "{ref}", "-c", "{r1}", "{r2}", "-p", "minimap2-sr",
         "-m", "mean", "covered_bases", "--contig-end-exclusion", "0"], {}),
    "contig_interleaved": (
        ["contig", "-r", "{ref}", "--interleaved", "{inter}", "-m", "mean",
         "rpkm", "tpm"], {}),
    "contig_single_two_samples": (
        ["contig", "-r", "{ref}", "--single", "{single}", "{r1}", "-m",
         "mean", "count", "reads_per_base", "--output-format", "sparse"],
        {}),
    "contig_single_spilled": (
        ["contig", "-r", "{ref}", "--single", "{single}", "-m", "mean",
         "variance"], SPILL),
    "contig_inline_filter": (
        ["contig", "-r", "{ref}", "--single", "{single}", "-m", "mean",
         "count", "--min-read-percent-identity", "97",
         "--min-read-aligned-length", "90"], {}),
    "genome_fasta_files": (
        ["genome", "-f", "{gA}", "{gB}", "--single", "{single}", "-m",
         "relative_abundance", "mean", "covered_fraction",
         "--min-covered-fraction", "0"], {}),
    "genome_fasta_directory_paired": (
        ["genome", "-d", "{gdir}", "-x", "fna", "-1", "{r1}", "-2", "{r2}",
         "-m", "mean", "trimmed_mean", "relative_abundance"], {}),
    "contig_sharded_reads": (
        ["contig", "--sharded", "-r", "{ref}", "{ref2}", "-1", "{r1}", "-2",
         "{r2}", "-m", "mean", "count", "--min-covered-fraction", "0"], {}),
    "genome_sharded_bams_memory": (
        ["genome", "--sharded", "-s", "~", "-b", "{s1}", "{s2}", "-m",
         "mean", "relative_abundance", "covered_fraction"], WHOLE),
    "genome_sharded_bams_streamed_excluded": (
        ["genome", "--sharded", "-s", "~", "-b", "{s1}", "{s2}",
         "--exclude-genomes-from-deshard", "{exclude}", "-m", "mean",
         "trimmed_mean", "variance"], STREAMED),
    "contig_sharded_bams_filtered": (
        ["contig", "--sharded", "-b", "{s1}", "{s2}", "-m", "mean", "count",
         "--min-read-percent-identity", "98"], STREAMED),
    "contig_strobealign_aemb": (
        ["contig", "-r", "{ref}", "--single", "{single}", "-m",
         "strobealign-aemb"], {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stdout_byte_equal(data, case):
    argv, env = CASES[case]
    argv = [a.format(**data) for a in argv]
    (rc_j, out_j, err_j), (rc_t, out_t, err_t) = run_both(
        [argv, argv], env, path_dir=data["bindir"])
    assert rc_j == 0, err_j
    assert rc_t == 0, err_t
    assert out_j.count(b"\n") >= 2
    assert out_t == out_j


def _records(path):
    r = BamReader(path)
    b = r.batch
    return r.header.target_names, [bytes(b.data[s:e]) for s, e in
                                   zip(b.rec_start, b.rec_end)]


@pytest.mark.parametrize("how", ["directory", "files"])
def test_bam_caches_equal(data, tmp_path, how):
    """--bam-file-cache-directory / --cache-unfiltered-bam-files: same TSV
    and the same cached records from both packages."""
    caches, argvs = [], []
    for pkg in ("jax", "torch"):
        if how == "directory":
            cache = str(tmp_path / f"{pkg}_cache")
            extra = ["--bam-file-cache-directory", cache]
            caches.append(os.path.join(cache, "ref.fna.r1.fq.bam"))
        else:
            caches.append(str(tmp_path / f"{pkg}.bam"))
            extra = ["--cache-unfiltered-bam-files", caches[-1]]
        argvs.append(["contig", "-r", data["ref"], "-1", data["r1"], "-2",
                      data["r2"], "-m", "mean", *extra])
    (rc_j, out_j, err_j), (rc_t, out_t, err_t) = run_both(
        argvs, path_dir=data["bindir"])
    assert rc_j == 0, err_j
    assert rc_t == 0, err_t
    assert out_t == out_j
    names_j, recs_j = _records(caches[0])
    names_t, recs_t = _records(caches[1])
    assert names_t == names_j
    assert len(recs_j) == 320
    assert recs_t == recs_j


@pytest.mark.parametrize("discard", [False, True])
def test_make_writes_the_same_records(data, tmp_path, discard):
    argvs = [["make", "-r", data["ref"], "--single", data["single"],
              data["r1"], "-o", str(tmp_path / pkg)]
             + (["--discard-unmapped"] if discard else [])
             for pkg in ("jax", "torch")]
    (rc_j, _o, err_j), (rc_t, _o2, err_t) = run_both(
        argvs, SPILL, path_dir=data["bindir"])
    assert rc_j == 0, err_j
    assert rc_t == 0, err_t
    made = sorted(os.listdir(tmp_path / "jax"))
    assert made == ["ref.fna.r1.fq.bam", "ref.fna.single.fq.bam"]
    assert sorted(os.listdir(tmp_path / "torch")) == made
    for name in made:
        names_j, recs_j = _records(str(tmp_path / "jax" / name))
        names_t, recs_t = _records(str(tmp_path / "torch" / name))
        assert names_t == names_j and recs_t == recs_j
        assert len(recs_j) > 50


def test_spilled_sorter_equals_in_memory(data):
    """The tid-bucketed external sort yields the records of the in-memory
    sort, in the same order."""
    from coverm_tpu_torch.mapping.pipeline import sort_batch
    out = subprocess.run(
        [sys.executable, os.path.join(data["bindir"], "strobealign"),
         data["ref"], data["single"], data["r1"]],
        capture_output=True, text=True, check=True).stdout
    lines = out.splitlines(keepends=True)
    _h, mem = SamStreamConsumer(iter(lines), spill_bytes=1 << 40).run()
    mem = sort_batch(mem)
    header, batches = SamStreamConsumer(iter(lines), spill_bytes=3000).run()
    spilled = list(batches)
    assert len(spilled) > 1
    got = [bytes(b.data[s:e]) for b in spilled
           for s, e in zip(b.rec_start, b.rec_end)]
    want = [bytes(mem.data[s:e]) for s, e in zip(mem.rec_start, mem.rec_end)]
    assert got == want
    for f in ("tid", "pos", "block_start", "block_end"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(b, f) for b in spilled]),
            getattr(mem, f), err_msg=f)


@pytest.mark.parametrize("argv", [
    ["filter", "-b", "{s1}", "-o", "out.bam"],
    ["cluster", "-f", "{gA}", "{gB}"],
    ["makedb", "-r", "{ref}", "-o", "db"],
    ["contig", "-b", "{s1}", "--profile-dir", "p"],
    ["genome", "-f", "{gA}", "{gB}", "--single", "{single}",
     "--dereplicate"],
    ["genome", "-f", "{gA}", "{gB}", "--single", "{single}",
     "--min-completeness", "50"],
])
def test_routes_of_the_third_slice_match_jax(data, tmp_path, argv):
    """Routes that once exited as not yet ported, with the fake mappers on
    PATH: both packages give the same exit status, message, standard
    output and files."""
    argv = [a.format(**data) for a in argv]
    cwds = [tmp_path / "jax", tmp_path / "torch"]
    for c in cwds:
        c.mkdir()
    results = run_both([argv, argv], cwds=cwds, path_dir=data["bindir"])
    want, got = (outcome(r, c, traces=("p",))
                 for r, c in zip(results, cwds))
    assert got == want
    if argv[0] in ("filter", "makedb"):
        assert want[0] == 0 and want[3], want
