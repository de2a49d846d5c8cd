"""`filter` of the port (coverm_tpu_torch/filter_stream.py,
commands.run_filter) against `python -m coverm_tpu filter`, on the CPU.

The fixture (seed 5) is a coordinate-sorted BAM of proper and improper
pairs, singletons, secondary, supplementary and unmapped records with NM
tags, clipped and gapped CIGARs and mixed MAPQ, and its CRAM 3.0 twin
(the port's writer; CRAM goes through the BAM spool). Both packages run
side by side in their own directories; the exit status, the
`In sample ...` line on standard error, standard output and every file
written (the output BAMs) must be byte-equal, for single and pair
thresholds, `--inverse`, the flag options and two inputs at once. The
`contig` TSV over a filtered BAM must be byte-equal too.
"""

import numpy as np
import pytest

from coverm_tpu_torch.io import bgzf
from coverm_tpu_torch.io.cram import sam_to_cram_bytes
from coverm_tpu_torch.io.sam import sam_text_to_bam_data

from test_torch_cli_parity import outcome, run_both

CIGARS = ["100M", "5S95M", "48M2I50M", "60M3D40M", "30M1D30M1I39M"]


def _seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def sam_lines(seed=5, n_pairs=300, n_single=150):
    rng = np.random.default_rng(seed)
    lens = [6000, 4500, 8000]
    head = [f"@SQ\tSN:c{i}\tLN:{ln}" for i, ln in enumerate(lens)]
    recs = []

    def rec(name, flag, tid, pos, mapq, cigar, mtid, mpos, tlen, nm):
        mate = "=" if mtid == tid else (f"c{mtid}" if mtid >= 0 else "*")
        recs.append((tid, pos, f"{name}\t{flag}\tc{tid}\t{pos + 1}\t{mapq}\t"
                               f"{cigar}\t{mate}\t{mpos + 1}\t{tlen}\t"
                               f"{_seq(rng, 100)}\t{'I' * 100}\tNM:i:{nm}"))

    for k in range(n_pairs):
        tid = int(rng.integers(0, 3))
        p1 = int(rng.integers(0, lens[tid] - 400))
        p2 = p1 + int(rng.integers(0, 250))
        proper = rng.random() < 0.8
        f1, f2 = (99, 147) if proper else (97, 145)
        nm1, nm2 = (int(x) for x in rng.integers(0, 7, 2))
        mq1, mq2 = (int(x) for x in rng.integers(0, 61, 2))
        c1, c2 = (CIGARS[int(x)] for x in rng.integers(0, len(CIGARS), 2))
        rec(f"p{k}", f1, tid, p1, mq1, c1, tid, p2, p2 - p1 + 100, nm1)
        rec(f"p{k}", f2, tid, p2, mq2, c2, tid, p1, p1 - p2 - 100, nm2)
    for k in range(n_single):
        tid = int(rng.integers(0, 3))
        flag = [0, 16, 256, 2048, 0][k % 5]
        rec(f"s{k}", flag, tid, int(rng.integers(0, lens[tid] - 150)),
            int(rng.integers(0, 61)), CIGARS[k % len(CIGARS)], -1, -1, 0,
            int(rng.integers(0, 8)))
    recs.sort(key=lambda r: (r[0], r[1]))
    unmapped = [f"u{k}\t4\t*\t0\t0\t*\t*\t0\t0\t{_seq(rng, 100)}\t"
                f"{'I' * 100}" for k in range(10)]
    return head + [r[2] for r in recs] + unmapped


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("filter")
    lines = sam_lines()
    paths = {"bam": str(d / "x.bam"), "cram": str(d / "x.cram"),
             "bam2": str(d / "y.bam")}
    for key, seed in (("bam", 5), ("bam2", 6)):
        src = lines if seed == 5 else sam_lines(seed=seed)
        with open(paths[key], "wb") as f:
            w = bgzf.BgzfWriter(f)
            w.write(sam_text_to_bam_data(iter(src)))
            w.close()
    with open(paths["cram"], "wb") as f:
        f.write(sam_to_cram_bytes(iter(lines), records_per_slice=128))
    return paths


CASES = {
    "bam_no_thresholds": ["-b", "{bam}"],
    "bam_single_identity": ["-b", "{bam}", "--min-read-percent-identity",
                            "96"],
    "bam_single_identity_inverse": ["-b", "{bam}", "--inverse",
                                    "--min-read-percent-identity", "96"],
    "bam_single_length_and_percent": [
        "-b", "{bam}", "--min-read-aligned-length", "96",
        "--min-read-aligned-percent", "97"],
    "bam_pair_identity": ["-b", "{bam}", "--min-read-percent-identity-pair",
                          "96"],
    "bam_pair_length_inverse": ["-b", "{bam}", "--inverse",
                                "--min-read-aligned-length-pair", "195"],
    "bam_flags_and_mapq": ["-b", "{bam}", "--include-secondary",
                           "--exclude-supplementary", "--min-mapq", "20",
                           "--min-read-aligned-length", "50"],
    "bam_proper_pairs_only": ["-b", "{bam}", "--proper-pairs-only",
                              "--min-read-aligned-percent", "90"],
    "cram_single_identity": ["-b", "{cram}", "--min-read-percent-identity",
                             "96"],
    "cram_pair_percent_inverse": ["-b", "{cram}", "--inverse",
                                  "--min-read-aligned-percent-pair", "95"],
    "two_inputs": ["-b", "{bam}", "{bam2}", "-o", "o1.bam", "o2.bam",
                   "--min-read-percent-identity", "95"],
    "outputs_not_matching_inputs": ["-b", "{bam}", "-o", "o1.bam",
                                    "o2.bam"],
}


def _both(tmp_path, argv):
    cwds = [tmp_path / "jax", tmp_path / "torch"]
    for c in cwds:
        c.mkdir()
    return [outcome(r, c) for r, c in
            zip(run_both([argv, argv], cwds=cwds), cwds)]


@pytest.mark.parametrize("case", list(CASES))
def test_filter_equals_jax(data, tmp_path, case):
    argv = ["filter"] + [a.format(**data) for a in CASES[case]]
    if "-o" not in argv:
        argv += ["-o", "out.bam"]
    want, got = _both(tmp_path, argv)
    assert got == want
    rc, _out, message, files = want
    if case == "outputs_not_matching_inputs":
        assert rc != 0
        return
    assert rc == 0 and files
    for line in message:
        assert line.startswith("In sample '"), message
        kept, total = (int(w) for w in line.split()
                       if w.isdigit())
        if case != "bam_no_thresholds":
            assert 0 < kept < total, line


def test_contig_over_filtered_bam_equals_jax(data, tmp_path):
    """filter, then contig on its output: the chip smoke's phase 11 at a
    small size."""
    argv = ["filter", "-b", data["bam"], "-o", "out.bam",
            "--min-read-percent-identity", "96"]
    want, got = _both(tmp_path, argv)
    assert got == want and want[0] == 0
    argvs = [["contig", "-b", str(tmp_path / side / "out.bam"), "-m",
              "mean", "trimmed_mean", "variance", "covered_fraction",
              "count"] for side in ("jax", "torch")]
    (rc_j, out_j, err_j), (rc_t, out_t, err_t) = run_both(argvs)
    assert rc_j == 0, err_j
    assert rc_t == 0, err_t
    assert out_j.count(b"\n") == 4
    assert out_t == out_j
