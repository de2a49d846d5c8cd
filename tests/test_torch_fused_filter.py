"""The single-read filter inside the fused native BAM scan, on the CPU.

A streamed BGZF BAM under a single-read-only filter (metabat's 97%
identity preset, --min-read-* without a pair threshold) stays on the
fused native scan, which applies the filter in its record loop
(native/bamdecode.cpp scan_chunk_records). Its SampleScan must equal,
field by field, the JAX package's classic route (coverm_tpu's
BamStreamReader, readfilter.filter_payload, then scan_sample_batches)
and the port's own (COVERM_TPU_FUSED=0), with the primary alignments
counted before the filter as the classic routes' num_primary_override
counts them; an error must be the same error, by class name and
message. The integer fields and the depth statistics are held exactly;
the two float identity sums to a relative 1e-12, because the fused scan
adds a contig's identities in partial sums a segment and the classic
routes in one bincount (as in tests/test_torch_native_build.py).

The BAMs are written from a numpy seed with records on each side of the
filter: identities straddling 0.97001 where float32 and float64 disagree
(NM 90 of 3001 aligned passes in float32 only), NM 3 of 100 and NM 29 of
1000, NM absent, aligned length 0, secondary records stored without SEQ
(l_seq 0), supplementary records, mapq 255 and mapq thresholds, placed
and unplaced unmapped records, and a record out of order that the
filter drops. Segments of 8 KiB over BGZF blocks of 4,000 bytes make
every stream span many segments.
"""

import dataclasses

import numpy as np
import pytest

from coverm_tpu.flags import FlagFilter as JFlagFilter
from coverm_tpu.io.bam import BamStreamReader as JBamStreamReader
from coverm_tpu.ops.depth import ReferenceLayout as JLayout
from coverm_tpu.readfilter import FilterParams as JFilterParams
from coverm_tpu.readfilter import filter_payload as j_filter_payload
from coverm_tpu.scan import scan_sample_batches as j_scan_batches
from coverm_tpu_torch import modes
from coverm_tpu_torch.commands import FilteredBamFileSource
from coverm_tpu_torch.flags import FlagFilter
from coverm_tpu_torch.io import bgzf
from coverm_tpu_torch.io.bam import BamReader
from coverm_tpu_torch.io.fastscan import FusedScanStream, fused_available
from coverm_tpu_torch.io.sam import sam_text_to_bam_data
from coverm_tpu_torch.ops.depth import ReferenceLayout
from coverm_tpu_torch.readfilter import FilterParams
from coverm_tpu_torch.scan import scan_any

from test_torch_native_build import jax_native  # noqa: F401

BLOCK = 4000
SEG = 8192
EE = 75
CONTIG_LEN = 30000
N_CONTIGS = 6

INT_FIELDS = ("observed", "reads_primary", "reads_nonsupp", "reads_all",
              "nm_sum", "indel_sum")
FLOAT_FIELDS = ("identity_sum_primary", "identity_sum_nonsupp")
DEPTH_FIELDS = ("sum_depth_window", "covered_window", "covered_full",
                "max_depth_window", "trimmed_sum", "sumsq_window",
                "min_depth_window")

METABAT = (FilterParams(min_percent_identity_single=0.97001),
           FlagFilter(include_improper_pairs=True, include_supplementary=True,
                      include_secondary=True))
PARAMS = {
    "metabat": METABAT,
    "mapq30": (FilterParams(min_mapq=30), FlagFilter()),
    "every_threshold": (FilterParams(min_percent_identity_single=0.95,
                                     min_aligned_length_single=60,
                                     min_aligned_percent_single=0.9,
                                     min_mapq=20), FlagFilter()),
    "aligned_percent_secondary": (
        FilterParams(min_aligned_percent_single=0.5),
        FlagFilter(include_secondary=True, include_supplementary=False)),
}


def _sam_line(name, flag, tid, pos, mapq, cigar, seq, nm):
    rname = "*" if tid < 0 else f"c{tid}"
    tag = "" if nm is None else f"\tNM:i:{nm}"
    return (f"{name}\t{flag}\t{rname}\t{pos + 1 if tid >= 0 else 0}\t{mapq}"
            f"\t{cigar}\t*\t0\t0\t{seq}\t*{tag}\tAS:i:0")


def write_bam(path, seed=0, n_reads=2500, no_nm=False, late_passes=False):
    """A coordinate-sorted BGZF BAM (but for one late record) with the
    records of the module docstring. no_nm: NM dropped from the reads of
    mapq 5; late_passes: the out-of-order record passes every filter."""
    rng = np.random.default_rng(seed)
    cigars = [("100M", 100), ("10S90M", 100), ("40M2I58M", 100),
              ("50M3D50M", 100), ("100S", 100)]
    flags = [0, 0, 16, 2, 99, 256, 2048, 4]
    recs = []  # (tid, pos, sam line)
    tids = np.sort(rng.integers(0, N_CONTIGS, n_reads))
    starts = rng.integers(0, CONTIG_LEN - 9000, n_reads)
    for j in range(n_reads):
        t, s = int(tids[j]), int(starts[j])
        cig, ln = cigars[int(rng.integers(0, len(cigars)))]
        flag = flags[int(rng.integers(0, len(flags)))]
        mapq = [0, 5, 20, 30, 60, 255][int(rng.integers(0, 6))]
        nm = int(rng.integers(0, 7))
        if no_nm and mapq == 5:
            nm = None
        seq = "*" if flag == 256 and j % 2 else "A" * ln
        if flag & 4:  # placed unmapped: the mate's contig and position
            cig, seq, nm, mapq = "*", "A" * 100, None, 0
        recs.append((t, s, _sam_line(f"r{j}", flag, t, s, mapq, cig, seq,
                                     nm)))
    special = [
        # identity 1 - 90/3001: >= 0.97001 in float32, not in float64
        (0, 100, 0, 60, "50M2901D50M", "A" * 100, 90),
        (1, 200, 0, 60, "50M7936D50M", "A" * 100, 241),
        # NM 3 of 100 (0.97, dropped) and 29 of 1000 (0.971, kept)
        (2, 300, 0, 60, "100M", "A" * 100, 3),
        (2, 310, 0, 60, "50M900D50M", "A" * 100, 29),
        # aligned length 0: identity 0/0 is NaN and fails every test
        (3, 400, 0, 60, "100S", "A" * 100, 0),
        # secondary without SEQ: aligned / 0 is inf; 0 / 0 is NaN
        (3, 500, 256, 60, "100M", "*", 1),
        (3, 510, 256, 60, "100S", "*", 0),
        (4, 600, 2048, 60, "60M40S", "A" * 100, 1),
        (4, 700, 0, 255, "100M", "A" * 100, 0),
    ]
    for k, (t, s, flag, mapq, cig, seq, nm) in enumerate(special):
        recs.append((t, s, _sam_line(f"s{k}", flag, t, s, mapq, cig, seq,
                                     nm)))
    recs.sort(key=lambda r: (r[0], r[1]))
    # a record of the last contig among the first contig's records: the
    # filters drop it (aligned length 0) unless late_passes
    late = ("100M", 0) if late_passes else ("100S", 0)
    at = next(i for i, r in enumerate(recs) if r[0] == 1)
    recs.insert(at, (N_CONTIGS - 1, 50, _sam_line(
        "late", 0, N_CONTIGS - 1, 50, 60, late[0], "A" * 100, late[1])))
    sam = [f"@SQ\tSN:c{i}\tLN:{CONTIG_LEN}" for i in range(N_CONTIGS)]
    sam += [r[2] for r in recs]
    sam += [_sam_line(f"u{j}", 4, -1, 0, 0, "*", "A" * 100, None)
            for j in range(300)]  # unplaced unmapped tail
    data = sam_text_to_bam_data(iter(sam))
    with open(path, "wb") as f:
        for o in range(0, len(data), BLOCK):
            f.write(bgzf.compress_block(data[o:o + BLOCK], 1))
        f.write(bgzf.BGZF_EOF)
    return path


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("ff")
    return {
        "mixed": write_bam(str(d / "mixed.bam")),
        "other_seed": write_bam(str(d / "seed5.bam"), seed=5, n_reads=4000),
        "no_nm": write_bam(str(d / "no_nm.bam"), no_nm=True),
        "unsorted": write_bam(str(d / "unsorted.bam"), late_passes=True),
    }


@pytest.fixture(autouse=True)
def streamed(monkeypatch):
    if not fused_available():
        pytest.skip("native fused scan unavailable")
    monkeypatch.setattr(modes, "STREAM_THRESHOLD_BYTES", 1)
    monkeypatch.setenv("COVERM_TPU_SEGMENT_BYTES", str(SEG))


def scan_of(path, params, ff, fused, monkeypatch):
    """(SampleScan or (error class, message), payload) of a filtered
    source's streamed scan on the CPU, the primary alignments taken as
    the modes take them (num_primary_override when set)."""
    monkeypatch.setenv("COVERM_TPU_FUSED", "1" if fused else "0")
    source = FilteredBamFileSource(path, params, ff, device="cpu")
    header, payload = source.read()
    layout = ReferenceLayout.build(header.target_lens, EE)
    try:
        scan = scan_any(header, payload, layout, ff, need_hist=False,
                        device="cpu")
    except Exception as e:
        return (type(e).__name__, str(e)), payload
    finally:
        source.finish()
    if source.num_primary_override is not None:
        scan.num_detected_primary_alignments = source.num_primary_override
    return scan, payload


def jax_scan_of(path, params, ff):
    """The JAX package's classic filtered route over the same BAM in the
    same segments: SampleScan, or (error class, message)."""
    class Source:
        num_primary_override = None

    source = Source()
    header, gen = JBamStreamReader(path, target_bytes=SEG).read()
    jff = JFlagFilter(**dataclasses.asdict(ff))
    gen = j_filter_payload(source, gen,
                           JFilterParams(**dataclasses.asdict(params)), jff)
    try:
        scan = j_scan_batches(header, gen,
                              JLayout.build(header.target_lens, EE), jff,
                              False)
    except Exception as e:
        return type(e).__name__, str(e)
    scan.num_detected_primary_alignments = source.num_primary_override
    return scan


def assert_same(got, want):
    if isinstance(want, tuple) or isinstance(got, tuple):
        assert got == want
        return
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, atol=0, err_msg=f)
    assert (got.num_detected_primary_alignments
            == want.num_detected_primary_alignments)
    for f in DEPTH_FIELDS:
        a, b = getattr(got.depth, f), getattr(want.depth, f)
        if a is None or b is None:
            assert a is None and b is None, f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


CASES = [("mixed", p) for p in PARAMS] + [
    ("other_seed", "metabat"), ("other_seed", "every_threshold"),
    ("no_nm", "metabat"), ("no_nm", "mapq30"), ("unsorted", "metabat"),
    ("unsorted", "mapq30")]


@pytest.mark.parametrize("bam,params", CASES)
def test_fused_filter_equals_classic(bams, bam, params, monkeypatch):
    params, ff = PARAMS[params]
    got, payload = scan_of(bams[bam], params, ff, True, monkeypatch)
    assert isinstance(payload, FusedScanStream)
    assert payload.read_filter is params
    want, classic = scan_of(bams[bam], params, ff, False, monkeypatch)
    assert not isinstance(classic, FusedScanStream)
    assert_same(got, want)


@pytest.mark.parametrize("bam,params", CASES)
def test_fused_filter_equals_jax(bams, bam, params, monkeypatch):
    """Both of the port's routes against the JAX package's classic route
    on the same edge cases."""
    params, ff = PARAMS[params]
    want = jax_scan_of(bams[bam], params, ff)
    got, payload = scan_of(bams[bam], params, ff, True, monkeypatch)
    assert isinstance(payload, FusedScanStream)
    assert_same(got, want)
    got, payload = scan_of(bams[bam], params, ff, False, monkeypatch)
    assert not isinstance(payload, FusedScanStream)
    assert_same(got, want)


def test_the_filter_keeps_and_drops(bams, monkeypatch):
    """The fixtures do reach both sides: under metabat's preset the
    mixed BAM keeps some mapped records and drops others, the primary
    alignments count every record of the file, NM absent is an error,
    and the late record raises only when it passes."""
    params, ff = METABAT
    path = bams["mixed"]
    scan, _ = scan_of(path, params, ff, True, monkeypatch)
    every = BamReader(path).batch
    mapped = int(np.count_nonzero(~every.is_unmapped()))
    assert 0 < int(scan.reads_all.sum()) < mapped
    assert scan.num_detected_primary_alignments == int(
        np.count_nonzero(every.is_primary()))
    err, _ = scan_of(bams["no_nm"], params, ff, True, monkeypatch)
    assert err[0] == "MissingNMTagError"
    err, _ = scan_of(bams["unsorted"], params, ff, True, monkeypatch)
    assert err[0] == "BamSortingError"


@pytest.mark.parametrize("nm,aligned,kept", [
    (90, 3001, True), (241, 8036, True), (3, 100, False), (29, 1000, True),
    (0, 0, False), (-1, 0, True), (-1, 100, True)])
def test_float32_identity_as_numpy(nm, aligned, kept):
    """The identities of the fixtures: numpy's float32 test (which the
    native loop must reproduce) against the verdict in float64, where
    the two differ for NM 90 of 3001 and NM 241 of 8036."""
    f32 = np.float32
    with np.errstate(divide="ignore", invalid="ignore"):
        ident = f32(1.0) - f32(nm) / f32(aligned)
    assert bool(ident >= f32(0.97001)) is kept
    if nm > 0 and aligned > 1000:
        assert 1.0 - nm / aligned < 0.97001


@pytest.mark.parametrize("params,fused", [
    (FilterParams(min_percent_identity_pair=0.97), False),
    (FilterParams(min_mapq=30), True),
    (FilterParams(), False)])
def test_pair_filters_stay_classic(bams, params, fused, monkeypatch):
    """Only the single-read-only mode rides the fused scan; a pair
    threshold (and the pair path that no threshold selects) keeps the
    classic batches."""
    monkeypatch.setenv("COVERM_TPU_FUSED", "1")
    source = FilteredBamFileSource(bams["mixed"], params, FlagFilter())
    _, payload = source.read()
    source.finish()
    assert isinstance(payload, FusedScanStream) is fused
