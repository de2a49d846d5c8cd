"""CRAM input of the port (coverm_tpu_torch/io/cram.py and the CRAM plan
of io/fastscan.py) against the JAX package, on the CPU.

The fixtures are CRAM 3.0 files written here with the port's own writer
(`sam_to_cram_bytes`). Each is scanned by both packages on three routes:
the direct per-slice stats route, the legacy BAM-materialising route
(COVERM_TPU_CRAM_STATS=0), and the per-slice python fallback (the native
slice decoder made to reject every slice). Integer fields must be equal
and the identity sums bit-equal. The CLI's standard output must be
byte-equal, and for unsorted, missing-NM and truncated CRAMs the exit
code and the `Error:` line. The port's codecs round-trip, and the CRAM
twin of the synthetic BAM gives the BAM's TSV.
"""

import re

import numpy as np
import pytest

from coverm_tpu.flags import FlagFilter as JFlagFilter
from coverm_tpu.io import native as jnative
from coverm_tpu.io.fastscan import FusedScanStream as JFused
from coverm_tpu.io.fastscan import scan_sample_fused as j_scan_fused
from coverm_tpu.ops.depth import ReferenceLayout as JLayout
from coverm_tpu_torch.cli import main
from coverm_tpu_torch.flags import FlagFilter
from coverm_tpu_torch.io import cram as C
from coverm_tpu_torch.io import native
from coverm_tpu_torch.io.fastscan import FusedScanStream, scan_sample_fused
from coverm_tpu_torch.modes import BamFileSource
from coverm_tpu_torch.ops.depth import ReferenceLayout
from coverm_tpu_torch.synth import write_cram_twin, write_sorted_bam

from test_torch_cli_parity import STREAMED, WHOLE, _run_pair
from test_torch_scan import assert_scans_equal
from test_torch_native_build import jax_native  # noqa: F401

TRIM = (0.1, 0.9)
EE = 75

needs_native = pytest.mark.skipif(
    native.get_lib() is None
    or not hasattr(native.get_lib(), "ct_cram_stats_slice"),
    reason="native CRAM stats decoder unavailable")


def sam_lines(n=400, n_contigs=3, paired=False, seed=0):
    """A copy of tests/test_cram_stats_path.py's generator: mixed flags
    (secondary, supplementary, unmapped, duplicate, proper pairs),
    CIGARs with clips, indels and skips, extra tags on some records."""
    rng = np.random.default_rng(seed)
    lens = [60000, 40000, 90000]
    sam = [f"@SQ\tSN:c{i}\tLN:{lens[i]}" for i in range(n_contigs)]
    recs = []
    for j in range(n):
        tid = int(rng.integers(0, n_contigs))
        pos = int(rng.integers(1, lens[tid] - 200))
        flag = 0
        if j % 11 == 3:
            flag |= 0x100
        if j % 13 == 5:
            flag |= 0x800
        if j % 17 == 7:
            flag |= 0x4
        if j % 19 == 9:
            flag |= 0x400
        if paired:
            flag |= 0x1 | (0x2 if j % 3 else 0)
        cig = ["60M", "20M2D20M5I15M", "8S40M3N12M", "30M1I29M"][j % 4]
        L = sum(int(x) for x, op in re.findall(r"(\d+)([MIS=X])", cig))
        if flag & 0x4:
            cig = "*"
            L = 50
        seq = ("ACGT" * 40)[:L]
        recs.append((tid, pos, j, flag, cig, seq))
    recs.sort(key=lambda r: (r[0], r[1]))
    for tid, pos, j, flag, cig, seq in recs:
        extra = "\tAS:i:77\tXZ:Z:hello" if j % 6 == 0 else ""
        sam.append(f"r{j}\t{flag}\tc{tid}\t{pos}\t{30 + j % 30}\t{cig}"
                   f"\t*\t0\t0\t{seq}\t{'I' * len(seq)}\tNM:i:{j % 5}{extra}")
    return sam


def nf_lines():
    """Proper pairs whose mates are linked downstream (NF)."""
    sam = ["@SQ\tSN:cA\tLN:50000"]
    for j in range(120):
        p1, p2 = 100 + 7 * j, 160 + 7 * j
        sam.append(f"p{j}\t99\tcA\t{p1}\t60\t40M\t=\t{p2}\t100\t{'A' * 40}"
                   f"\t{'I' * 40}\tNM:i:1")
        sam.append(f"p{j}\t147\tcA\t{p2}\t60\t40M\t=\t{p1}\t-100\t"
                   f"{'C' * 40}\t{'I' * 40}\tNM:i:0")
    return sam


FIXTURES = {
    "mixed_flags": lambda: C.sam_to_cram_bytes(
        iter(sam_lines(400, paired=True)), records_per_slice=64),
    "multiref_slices": lambda: C.sam_to_cram_bytes(
        iter(sam_lines(300)), records_per_slice=299),
    "nf_mate_links": lambda: C.sam_to_cram_bytes(
        iter(nf_lines()), records_per_slice=80, use_nf=True),
    "ap_delta_off": lambda: C.sam_to_cram_bytes(
        iter(sam_lines(200)), records_per_slice=64, ap_delta=False),
}
ROUTES = ("direct", "legacy", "fallback")


def write(tmp_path, raw, name="x.cram"):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(raw)
    return p


def scan_both(path, route, monkeypatch, ff=None, need_hist=False,
              trim=TRIM):
    """SampleScan of the port and of the JAX package on one route;
    asserts the direct-stats plan engaged exactly when it should."""
    if route == "legacy":
        monkeypatch.setenv("COVERM_TPU_CRAM_STATS", "0")
    if route == "fallback":
        monkeypatch.setattr(native, "cram_stats_decode",
                            lambda *a, **k: None)
        monkeypatch.setattr(jnative, "cram_stats_slice",
                            lambda *a, **k: None)
    s = FusedScanStream(path)
    h = s.open()
    assert (s._cram is not None) == (route != "legacy")
    got = scan_sample_fused(h, s, ReferenceLayout.build(h.target_lens, EE),
                            FlagFilter(**(ff or {})), need_hist, trim=trim,
                            device="cpu")
    assert s._cram is None  # the plan's mmap and file are closed
    js = JFused(path)
    jh = js.open()
    want = j_scan_fused(jh, js, JLayout.build(jh.target_lens, EE),
                        JFlagFilter(**(ff or {})), need_hist, trim=trim)
    return got, want


@needs_native
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_sample_scan_matches_jax(tmp_path, monkeypatch, fixture, route):
    path = write(tmp_path, FIXTURES[fixture]())
    ff = {"include_improper_pairs": False} if fixture == "mixed_flags" \
        else None
    got, want = scan_both(path, route, monkeypatch, ff=ff)
    assert_scans_equal(got, want)
    assert got.reads_all.sum() > 0


@needs_native
@pytest.mark.parametrize("route", ROUTES)
def test_sample_scan_need_hist_matches_jax(tmp_path, monkeypatch, route):
    path = write(tmp_path, C.sam_to_cram_bytes(iter(sam_lines(300)),
                                               records_per_slice=64))
    got, want = scan_both(path, route, monkeypatch, need_hist=True,
                          trim=None)
    assert_scans_equal(got, want, hist=True)


def test_unconsumed_plan_closes_with_its_source(tmp_path, monkeypatch):
    """A CRAM plan that no fused scan read (COVERM_TPU_FUSED=0 iterates
    record batches instead) is closed by the source's finish()."""
    path = write(tmp_path, FIXTURES["ap_delta_off"]())
    src = BamFileSource(path)
    _header, stream = src.read()
    assert isinstance(stream, FusedScanStream)
    plan = stream._cram
    src.finish()
    assert stream._cram is None
    if plan is not None:
        assert plan[0].closed and plan[2].closed


@pytest.fixture(scope="module")
def crams(tmp_path_factory):
    d = tmp_path_factory.mktemp("cram_cli")
    paths = {
        "a": write(d, C.sam_to_cram_bytes(iter(sam_lines(500, seed=1)),
                                          records_per_slice=64), "a.cram"),
        "b": write(d, C.sam_to_cram_bytes(iter(sam_lines(400, seed=2)),
                                          records_per_slice=300), "b.cram"),
    }
    unsorted = ["@SQ\tSN:cA\tLN:50000", "@SQ\tSN:cB\tLN:50000",
                f"r0\t0\tcB\t100\t60\t40M\t*\t0\t0\t{'A' * 40}\t*\tNM:i:0",
                f"r1\t0\tcA\t100\t60\t40M\t*\t0\t0\t{'A' * 40}\t*\tNM:i:0"]
    paths["unsorted"] = write(d, C.sam_to_cram_bytes(
        iter(unsorted), records_per_slice=1), "unsorted.cram")
    no_nm = ["@SQ\tSN:cA\tLN:50000",
             f"r0\t0\tcA\t100\t60\t40M\t*\t0\t0\t{'A' * 40}\t*"]
    paths["no_nm"] = write(d, C.sam_to_cram_bytes(iter(no_nm)),
                           "no_nm.cram")
    raw = C.sam_to_cram_bytes(iter(sam_lines(200)), records_per_slice=200)
    paths["truncated"] = write(d, raw[:len(raw) - 38 - 25],
                               "truncated.cram")
    genomes = d / "genomes.tsv"
    genomes.write_text("gA\tc0\ngA\tc1\ngB\tc2\n")
    paths["def"] = str(genomes)
    return paths


LEGACY = {"COVERM_TPU_CRAM_STATS": "0"}
CLI_CASES = {
    "contig_direct": (["contig", "-b", "{a}", "{b}", "-m", "mean",
                       "trimmed_mean", "variance", "covered_fraction",
                       "count", "anir"], {}),
    "contig_legacy": (["contig", "-b", "{a}", "-m", "mean", "variance",
                       "covered_bases", "length"], LEGACY),
    "contig_histogram_direct": (["contig", "-b", "{b}", "-m",
                                 "coverage_histogram"], {}),
    "genome_definition_direct": (
        ["genome", "-b", "{a}", "--genome-definition", "{def}", "-m",
         "mean", "relative_abundance", "covered_fraction", "trimmed_mean"],
        {}),
    "genome_separator_legacy": (
        ["genome", "-s", "c", "-b", "{b}", "-m", "relative_abundance",
         "mean", "rpkm", "tpm"], {**LEGACY, **STREAMED}),
}


@needs_native
@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_stdout_byte_equal(crams, case):
    argv, env = CLI_CASES[case]
    argv = [a.format(**crams) for a in argv]
    (rc_j, out_j, err_j), (rc_t, out_t, err_t) = _run_pair(argv, env)
    assert rc_j == 0, err_j
    assert rc_t == 0, err_t
    assert out_j.count(b"\n") >= 2
    assert out_t == out_j


@needs_native
@pytest.mark.parametrize("kind,env", [("unsorted", {}),
                                      ("unsorted", LEGACY),
                                      ("no_nm", {}),
                                      ("truncated", {}),
                                      ("truncated", WHOLE)])
def test_errors_equal(crams, kind, env):
    argv = ["contig", "-b", crams[kind], "-m", "mean"]
    (rc_j, out_j, err_j), (rc_t, out_t, err_t) = _run_pair(argv, env)
    assert rc_j != 0
    assert rc_t == rc_j

    def error_line(err):
        return [line for line in err.splitlines()
                if line.startswith("Error:")]

    assert error_line(err_j), err_j
    assert error_line(err_t) == error_line(err_j)
    assert out_t == out_j


ITF8_VALUES = [0, 1, 127, 128, 0x3FFF, 0x4000, 0x1FFFFF, 0x200000,
               0xFFFFFFF, 0x10000000, 2 ** 31 - 1, -1, -2 ** 31]
LTF8_VALUES = [0, 127, 128, 0x3FFF, 0x4000, 2 ** 21, 2 ** 35, 2 ** 49,
               2 ** 56, 2 ** 63 - 1, -1]


@pytest.mark.parametrize("v", ITF8_VALUES)
def test_itf8_round_trip(v):
    b = C.write_itf8(v)
    got, p = C.read_itf8(b + b"\xff", 0)
    assert p == len(b)
    assert got == v


@pytest.mark.parametrize("v", LTF8_VALUES)
def test_ltf8_round_trip(v):
    b = C.write_ltf8(v)
    got, p = C.read_ltf8(b + b"\xff", 0)
    assert p == len(b)
    assert got == v


RANS_INPUTS = {
    "one_byte": b"A",
    "three_bytes": b"ACG",
    "uniform": bytes(range(256)) * 8,
    "skewed": np.random.default_rng(5).choice(
        np.frombuffer(b"ACGTN", np.uint8), 5000,
        p=[0.4, 0.3, 0.2, 0.09, 0.01]).tobytes(),
    "qualities": (bytes(range(30, 41)) * 700)[:7001],
}


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name", list(RANS_INPUTS))
def test_rans_round_trip(name, order):
    data = RANS_INPUTS[name]
    blob = C.rans_compress(data, order)
    assert C.rans_decompress(blob) == data


def test_cram_twin_gives_the_bam_tsv(tmp_path):
    """synth.write_cram_twin holds the alignments of write_sorted_bam: the
    same TSV through the port on the direct CRAM route."""
    kw = dict(n_contigs=3, contig_len=40_000, coverage=5, seed=4)
    bam, cram = str(tmp_path / "t.bam"), str(tmp_path / "t.cram")
    bt = write_sorted_bam(bam, **kw)
    ct = write_cram_twin(cram, per_slice=300, **kw)
    for a, b in zip(bt, ct):
        np.testing.assert_array_equal(a, b)
    outs = []
    for path in (bam, cram):
        out = str(tmp_path / (path[-4:] + ".tsv"))
        assert main(["contig", "-b", path, "-m", "mean", "trimmed_mean",
                     "variance", "covered_fraction", "count", "-o", out],
                    device="cpu") == 0
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0].count(b"\n") == 4
    assert outs[0] == outs[1]
