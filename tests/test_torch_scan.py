"""The port's per-sample scan (coverm_tpu_torch/scan.py, io/fastscan.py)
against the JAX package's, on the CPU: the fused native BGZF stream with
small segments (contigs and records straddle segment joints), the
classic contig-disjoint batch path, and the whole-file path. Every
SampleScan field must be equal; the per-read counts and the integer
depth statistics exactly, the identity sums bit for bit (both packages
run the same native decoder and the same numpy on the host)."""

import numpy as np
import pytest

from coverm_tpu.flags import FlagFilter as JFlagFilter
from coverm_tpu.io.bam import BamReader as JBamReader
from coverm_tpu.io.bam import BamStreamReader as JBamStreamReader
from coverm_tpu.io.fastscan import FusedScanStream as JFused
from coverm_tpu.io.fastscan import scan_sample_fused as j_scan_fused
from coverm_tpu.ops.depth import ReferenceLayout as JLayout
from coverm_tpu.scan import scan_any as j_scan_any
from coverm_tpu.scan import scan_sample_batches as j_scan_batches
from coverm_tpu_torch import scan as T
from coverm_tpu_torch.flags import FlagFilter
from coverm_tpu_torch.io import bgzf
from coverm_tpu_torch.io.bam import BamFormatError, BamReader, \
    BamStreamReader
from coverm_tpu_torch.io.fastscan import FusedScanStream, \
    fused_available, scan_sample_fused
from coverm_tpu_torch.io.sam import sam_text_to_bam_data
from coverm_tpu_torch.modes import _dense_hist
from coverm_tpu_torch.ops.depth import ReferenceLayout

from test_torch_native_build import jax_native  # noqa: F401

BLOCK = 4000   # BGZF block payload bytes: many blocks
SEG = 8192     # fused segment target: ~2 blocks per segment
TRIM = (0.1, 0.9)
EE = 75

INT_FIELDS = ("observed", "reads_primary", "reads_nonsupp", "reads_all",
              "nm_sum", "indel_sum", "identity_sum_primary",
              "identity_sum_nonsupp")
DEPTH_FIELDS = ("sum_depth_window", "covered_window", "covered_full",
                "max_depth_window", "trimmed_sum", "sumsq_window",
                "min_depth_window")


def write_bam(path, n_contigs=9, contig_len=20000, n_reads=3000, seed=0,
              empty=(2, 6), bad_sort=False, drop_nm=False):
    """A coordinate-sorted BGZF BAM with mixed flags (secondary,
    supplementary, unmapped, proper pairs), CIGARs with soft clips,
    insertions and deletions, and contigs without reads."""
    rng = np.random.default_rng(seed)
    sam = [f"@SQ\tSN:c{i}\tLN:{contig_len - 500 * i}"
           for i in range(n_contigs)]
    pool = np.setdiff1d(np.arange(n_contigs), empty)
    tids = np.sort(rng.choice(pool, n_reads))
    starts = (rng.random(n_reads) * (contig_len - 500 * tids - 200)
              ).astype(int)
    order = np.lexsort((starts, tids))
    if bad_sort:
        k = n_reads // 4  # a read of a later contig moved early
        order[k], order[-50] = order[-50], order[k]
    cigars = ["100M", "10S90M", "40M2I58M", "50M3D50M", "20M1D30M1I49M"]
    flags = [0, 0, 0, 2, 16, 256, 2048, 18]
    for j in order:
        cig = cigars[j % len(cigars)]
        flag = flags[int(rng.integers(0, len(flags)))]
        if bad_sort:
            flag = 0  # every read passes the filter and counts for order
        nm = "" if (drop_nm and j % 7 == 0) else \
            f"\tNM:i:{int(rng.integers(0, 6))}"
        sam.append(f"r{j}\t{flag}\tc{tids[j]}\t{starts[j] + 1}\t"
                   f"{int(rng.integers(0, 61))}\t{cig}\t*\t0\t0\t"
                   f"{'ACGT' * 25}\t*{nm}\tAS:i:100")
    for j in range(20):  # unmapped reads at the end
        sam.append(f"u{j}\t4\t*\t0\t0\t*\t*\t0\t0\t{'A' * 100}\t*")
    data = sam_text_to_bam_data(iter(sam))
    with open(path, "wb") as f:
        for o in range(0, len(data), BLOCK):
            f.write(bgzf.compress_block(data[o:o + BLOCK], 1))
        f.write(bgzf.BGZF_EOF)
    return path


def assert_scans_equal(got, want, hist=False):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert (got.num_detected_primary_alignments
            == want.num_detected_primary_alignments)
    assert got.header.target_names == want.header.target_names
    for f in DEPTH_FIELDS:
        a, b = getattr(got.depth, f), getattr(want.depth, f)
        if a is None or b is None:
            assert a is None and b is None, f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    if hist:
        a, b = _dense_hist(got.depth), _dense_hist(want.depth)
        W = max(a.shape[1], b.shape[1])
        pa = np.zeros((a.shape[0], W), np.int64)
        pb = np.zeros((b.shape[0], W), np.int64)
        pa[:, :a.shape[1]] = a
        pb[:, :b.shape[1]] = b
        np.testing.assert_array_equal(pa, pb, err_msg="hist")


FILTERS = [dict(), dict(include_secondary=True, include_supplementary=False),
           dict(include_improper_pairs=False)]


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    return write_bam(str(tmp_path_factory.mktemp("scan") / "s.bam"))


@pytest.mark.parametrize("flt", range(len(FILTERS)))
@pytest.mark.parametrize("need_hist", [False, True])
def test_fused_stream_matches_jax(bam, flt, need_hist):
    if not fused_available():
        pytest.skip("native fused scan unavailable")
    s = FusedScanStream(bam, target_bytes=SEG)
    h = s.open()
    got = scan_sample_fused(h, s, ReferenceLayout.build(h.target_lens, EE),
                            FlagFilter(**FILTERS[flt]), need_hist,
                            trim=TRIM, device="cpu")
    js = JFused(bam, target_bytes=SEG)
    jh = js.open()
    want = j_scan_fused(jh, js, JLayout.build(jh.target_lens, EE),
                        JFlagFilter(**FILTERS[flt]), need_hist, trim=TRIM)
    assert_scans_equal(got, want, hist=need_hist)


def test_classic_batches_match_jax(bam):
    h, gen = BamStreamReader(bam, target_bytes=SEG, device="cpu").read()
    got = T.scan_sample_batches(h, gen, ReferenceLayout.build(
        h.target_lens, EE), FlagFilter(), False, trim=TRIM, device="cpu")
    jh, jgen = JBamStreamReader(bam, target_bytes=SEG).read()
    want = j_scan_batches(jh, jgen, JLayout.build(jh.target_lens, EE),
                          JFlagFilter(), False, trim=TRIM)
    assert_scans_equal(got, want)


@pytest.mark.parametrize("need_hist", [False, True])
def test_whole_file_matches_jax(bam, need_hist):
    r = BamReader(bam)
    got = T.scan_any(r.header, r.batch, ReferenceLayout.build(
        r.header.target_lens, EE), FlagFilter(), need_hist, trim=TRIM,
        device="cpu")
    jr = JBamReader(bam)
    want = j_scan_any(jr.header, jr.batch, JLayout.build(
        jr.header.target_lens, EE), JFlagFilter(), need_hist, trim=TRIM)
    assert_scans_equal(got, want, hist=need_hist)


def test_fused_equals_whole_file(bam):
    """The port's two routes agree with each other too."""
    s = FusedScanStream(bam, target_bytes=SEG)
    h = s.open()
    layout = ReferenceLayout.build(h.target_lens, EE)
    fused = T.scan_any(h, s, layout, FlagFilter(), False, trim=TRIM,
                       device="cpu")
    r = BamReader(bam)
    whole = T.scan_any(r.header, r.batch, layout, FlagFilter(), False,
                       trim=TRIM, device="cpu")
    for f in DEPTH_FIELDS:
        np.testing.assert_array_equal(getattr(fused.depth, f),
                                      getattr(whole.depth, f), err_msg=f)
    np.testing.assert_array_equal(fused.reads_primary, whole.reads_primary)


@pytest.mark.parametrize("kind", ["unsorted", "missing_nm"])
def test_errors_match_jax(tmp_path, kind):
    path = write_bam(str(tmp_path / f"{kind}.bam"), n_reads=1200,
                     bad_sort=kind == "unsorted",
                     drop_nm=kind == "missing_nm")
    err = T.BamSortingError if kind == "unsorted" else T.MissingNMTagError

    def outcome(fused_cls, scan, layout_cls, ff, **kw):
        s = fused_cls(path, target_bytes=SEG)
        h = s.open()
        try:
            scan(h, s, layout_cls.build(h.target_lens, EE), ff, False,
                 trim=TRIM, **kw)
        except Exception as e:  # compared by class name and message
            return type(e).__name__, str(e)
        return None

    got = outcome(FusedScanStream, scan_sample_fused, ReferenceLayout,
                  FlagFilter(), device="cpu")
    want = outcome(JFused, j_scan_fused, JLayout, JFlagFilter())
    assert got is not None and got == want
    assert got[0] == err.__name__


def test_cram_is_refused(tmp_path):
    """A corrupt CRAM is refused with the JAX package's error."""
    from coverm_tpu.io.bam import BamFormatError as JBamFormatError
    path = tmp_path / "x.cram"
    path.write_bytes(b"CRAM\x03\x00" + bytes(64))
    with pytest.raises(BamFormatError) as got:
        FusedScanStream(str(path)).open()
    with pytest.raises(JBamFormatError) as want:
        JFused(str(path)).open()
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("Truncated or corrupt CRAM file")
