"""The port's classic record reader (io/bam.BamStreamReader) parses every
record once, on the CPU.

The BAM's first contig and its unplaced unmapped tail each span dozens
of 8 KiB segments. parse_records must see exactly the file's records;
the batches must stay contig-disjoint and, record for record, hold what
the JAX package's reader yields (which parses a held contig again with
every segment), the unplaced tail apart, which the port now yields as it
comes; the raw bytes behind rec_start/rec_end must be the records', and
the classic scan (filtered and not) must equal the JAX package's; seed 0.

The reader's card route (a BGZF file on a CUDA device: each segment
inflated into a card slot after the carry and parsed there by
ops/bam_scan.parse_segment) runs here with a CPU stand-in for the card,
as tests/test_torch_bam_scan.py runs the fused route's: SegmentInflater
on the CPU, whose slots send the parse to its plain version, and the
host's inflate (the reader's _segments) and parse_records_full made to
fail if they are reached. It must yield the host route's batches, batch
for batch and field for field (the bytes behind them included), at
several segment sizes, with a header that spans segments and records
that straddle them, parse every record once, hold the JAX reader's
records and raise the host route's error on a corrupt BGZF block; and
`--gff`, a pair filter, COVERM_TPU_FUSED=0 with `-m metabat` or a
single-read filter, `filter` and `--sharded` must print (and write) the
JAX package's bytes through it, only the pair filter, `filter` and
`--sharded` keeping the records' bytes. Without the bytes
(keep_bytes=False) both routes yield the same columns and carries,
concat_batches joins the columns alone, and the readers of whole
records raise.
"""

import contextlib
import io

import numpy as np
import pytest

from coverm_tpu.flags import FlagFilter as JFlagFilter
from coverm_tpu.io.bam import BamStreamReader as JBamStreamReader
from coverm_tpu.ops.depth import ReferenceLayout as JLayout
from coverm_tpu.readfilter import FilterParams as JFilterParams
from coverm_tpu.readfilter import filter_payload as j_filter_payload
from coverm_tpu.scan import scan_sample_batches as j_scan_batches
from coverm_tpu_torch import scan as T
from coverm_tpu_torch.flags import FlagFilter
from coverm_tpu_torch.io import bam as B
from coverm_tpu_torch.io import bgzf
from coverm_tpu_torch.io.sam import sam_text_to_bam_data
from coverm_tpu_torch.ops.depth import ReferenceLayout
from coverm_tpu_torch.readfilter import FilterParams, _mtid, filter_payload

from test_torch_native_build import jax_native  # noqa: F401
from test_torch_scan import assert_scans_equal

BLOCK = 4000
SEGS = (2048, 8192, 1 << 20)
EE = 75


def write_bam(path, seed=0):
    """Contig 0 with 3,000 reads, contigs 1-4 with 100-300 each (contig 3
    none), mates on their contig (readfilter._mtid reads them), placed
    unmapped reads among them, then 2,000 unplaced unmapped reads."""
    rng = np.random.default_rng(seed)
    counts = [3000, 300, 100, 0, 200]
    sam = [f"@SQ\tSN:c{i}\tLN:50000" for i in range(len(counts))]
    for t, n in enumerate(counts):
        for j, s in enumerate(np.sort(rng.integers(0, 49000, n))):
            flag = [0, 16, 99, 147, 256, 2048, 4][int(rng.integers(0, 7))]
            cig = "*" if flag == 4 else "100M"
            sam.append(f"r{t}_{j // 2}\t{flag}\tc{t}\t{s + 1}\t"
                       f"{int(rng.integers(0, 61))}\t{cig}\t=\t{s + 1}\t0\t"
                       f"{'ACGT' * 25}\t*\tNM:i:{int(rng.integers(0, 6))}")
    sam += [f"u{j}\t4\t*\t0\t0\t*\t*\t0\t0\t{'A' * 100}\t*"
            for j in range(2000)]
    data = sam_text_to_bam_data(iter(sam))
    with open(path, "wb") as f:
        for o in range(0, len(data), BLOCK):
            f.write(bgzf.compress_block(data[o:o + BLOCK], 1))
        f.write(bgzf.BGZF_EOF)
    return path, len(sam) - len(counts)


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    return write_bam(str(tmp_path_factory.mktemp("reader") / "r.bam"))


def records(batch):
    data = np.asarray(B._as_u8(batch.data))
    return [bytes(data[s:e]) for s, e in zip(batch.rec_start, batch.rec_end)]


def placed(batches):
    """The batches' records of a contig (tid >= 0), empty batches
    dropped."""
    out = [b.select(b.tid >= 0) for b in batches]
    return [b for b in out if b.n_records]


@pytest.mark.parametrize("seg", SEGS)
def test_every_record_is_parsed_once(bam, seg, monkeypatch):
    path, n_records = bam
    seen = []
    parse = B.parse_records

    def counting(*args, **kwargs):
        batch, end = parse(*args, **kwargs)
        seen.append(batch.n_records)
        return batch, end

    monkeypatch.setattr(B, "parse_records", counting)
    _, gen = B.BamStreamReader(path, target_bytes=seg, device="cpu").read()
    got = list(gen)
    assert sum(seen) == n_records
    assert sum(b.n_records for b in got) == n_records
    if seg < 1 << 20:
        assert len(seen) > 50  # the stream spans many segments


@pytest.mark.parametrize("seg", SEGS)
def test_batches_hold_the_jax_readers_records(bam, seg):
    path, _ = bam
    _, gen = B.BamStreamReader(path, target_bytes=seg, device="cpu").read()
    got = list(gen)
    _, jgen = JBamStreamReader(path, target_bytes=seg).read()
    want = list(jgen)
    # contig-disjoint: each contig in one batch
    tids = [set(b.tid[b.tid >= 0].tolist()) for b in got]
    assert sum(len(t) for t in tids) == len(set().union(*tids))
    # every record, in order, with its raw bytes
    assert sum((records(b) for b in got), []) == \
        sum((records(b) for b in want), [])
    got, want = placed(got), placed(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("tid", "pos", "flag", "mapq", "nm", "seq_len",
                  "aligned_cov", "aligned_pair", "indels", "qname_hash",
                  "block_read", "block_start", "block_end"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        assert records(a) == records(b)
        np.testing.assert_array_equal(_mtid(a), _mtid(b))


@pytest.mark.parametrize("filtered", [False, True])
def test_classic_scan_equals_jax(bam, filtered):
    path, _ = bam
    _, gen = B.BamStreamReader(path, target_bytes=SEGS[1],
                                device="cpu").read()
    _, jgen = JBamStreamReader(path, target_bytes=SEGS[1]).read()
    if filtered:  # a pair filter: mates joined through _mtid
        class Src:
            num_primary_override = None
        gen = filter_payload(Src(), gen,
                             FilterParams(min_percent_identity_pair=0.95),
                             FlagFilter())
        jgen = j_filter_payload(Src(), jgen,
                                JFilterParams(min_percent_identity_pair=0.95),
                                JFlagFilter())
    h = B.BamStreamReader(path, device="cpu").read()[0]
    got = T.scan_sample_batches(h, gen, ReferenceLayout.build(
        h.target_lens, EE), FlagFilter(), False, device="cpu")
    want = j_scan_batches(h, jgen, JLayout.build(h.target_lens, EE),
                          JFlagFilter(), False)
    assert int(got.reads_all.sum()) > 0
    assert_scans_equal(got, want)


# ---- the card route, the card stood in for by the CPU

FIELDS = ("tid", "pos", "flag", "mapq", "nm", "as_score", "seq_len",
          "aligned_cov", "aligned_single", "aligned_pair", "indels",
          "read_end", "qname_hash", "rec_start", "rec_end", "block_read",
          "block_start", "block_end")


def use_card_standin(monkeypatch):
    """The reader's card route with CPU tensors from here on: returns the
    list that gains the record count of every parse_segment call; the
    host's inflate and parse refuse."""
    from coverm_tpu_torch.io import fastscan, native
    from coverm_tpu_torch.ops import bam_scan as S
    from coverm_tpu_torch.ops import bgzf_inflate as BI
    parsed = []
    orig = S.parse_segment

    def counted(*args, **kwargs):
        ps = orig(*args, **kwargs)
        parsed.append(ps.n_records)
        return ps

    def refused(*args, **kwargs):
        raise AssertionError("the card route reached the host's ingest")
    monkeypatch.setattr(fastscan, "_card_inflater", lambda dev: (
        lambda *args: BI.SegmentInflater(*args, "cpu")))
    monkeypatch.setattr(S, "parse_segment", counted)
    monkeypatch.setattr(native, "parse_records_full", refused)
    monkeypatch.setattr(B.BamStreamReader, "_segments", refused)
    return parsed


def write_wide_header_bam(path, seed=1):
    """A BAM whose header (a long @CO text and 300 contigs) spans several
    4,000-byte BGZF blocks, then write_bam's kind of records on its first
    five contigs."""
    rng = np.random.default_rng(seed)
    sam = ["@CO\t" + "x" * 9000]
    sam += [f"@SQ\tSN:contig_{i}\tLN:{50000 + i}" for i in range(300)]
    for t in range(5):
        for j, s in enumerate(np.sort(rng.integers(0, 49000, 400))):
            sam.append(f"w{t}_{j}\t{[0, 16, 99, 147][j % 4]}\tcontig_{t}\t"
                       f"{s + 1}\t60\t100M\t=\t{s + 1}\t0\t"
                       f"{'ACGT' * 25}\t*\tNM:i:{j % 4}\tAS:i:{90 + j % 7}")
    data = sam_text_to_bam_data(iter(sam))
    with open(path, "wb") as f:
        for o in range(0, len(data), BLOCK):
            f.write(bgzf.compress_block(data[o:o + BLOCK], 1))
        f.write(bgzf.BGZF_EOF)
    return path, 2000


@pytest.fixture(scope="module")
def wide_bam(tmp_path_factory):
    return write_wide_header_bam(str(tmp_path_factory.mktemp("wide")
                                     / "w.bam"))


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        np.testing.assert_array_equal(B._as_u8(a.data), B._as_u8(b.data))


@pytest.mark.parametrize("which", ["bam", "wide_bam"])
@pytest.mark.parametrize("seg", (*SEGS, 700, 5000))
def test_card_route_yields_the_host_routes_batches(request, which, seg,
                                                   monkeypatch):
    """Batch for batch and field for field, the bytes behind rec_start
    and rec_end included: segments of one BGZF block (700), of a block
    and a part (5000: records straddle every cut), several blocks and
    the whole file; on wide_bam the header spans the first segments.
    Every record is parsed once, one parse a segment."""
    path, n_records = request.getfixturevalue(which)
    host = B.BamStreamReader(path, target_bytes=seg, device="cpu")
    _, want = host.read()
    want = list(want)
    parsed = use_card_standin(monkeypatch)
    header, gen = B.BamStreamReader(path, target_bytes=seg,
                                    device="cpu").read()
    got = list(gen)
    assert sum(parsed) == n_records == sum(b.n_records for b in got)
    assert header.target_names == host.header.target_names
    assert bytes(B._as_u8(header.raw)) == bytes(B._as_u8(host.header.raw))
    assert_batches_equal(got, want)
    if which == "wide_bam" and seg <= 5000:
        assert len(header.raw) > seg  # the header spans segments
    if seg < 1 << 20:
        assert len(parsed) > 10


@pytest.mark.parametrize("seg", SEGS)
def test_card_route_holds_the_jax_readers_records(bam, seg, monkeypatch):
    path, _ = bam
    use_card_standin(monkeypatch)
    _, gen = B.BamStreamReader(path, target_bytes=seg, device="cpu").read()
    got = list(gen)
    _, jgen = JBamStreamReader(path, target_bytes=seg).read()
    want = list(jgen)
    assert sum((records(b) for b in got), []) == \
        sum((records(b) for b in want), [])
    got, want = placed(got), placed(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("tid", "pos", "flag", "mapq", "nm", "as_score", "seq_len",
                  "aligned_cov", "aligned_pair", "indels", "read_end",
                  "qname_hash", "block_read", "block_start", "block_end"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        assert records(a) == records(b)


def test_card_route_raises_the_host_routes_error_on_a_corrupt_block(
        bam, tmp_path, monkeypatch):
    """A BGZF block that cannot inflate (block type 3) raises the host
    route's BamFormatError through the card route, with no fall-back."""
    from coverm_tpu_torch.io import native
    path, _ = bam
    data = np.fromfile(path, np.uint8)
    off, _, _ = native.bgzf_scan(data)
    data[off[off.size // 2] + 18] |= 0x06
    bad = str(tmp_path / "bad.bam")
    data.tofile(bad)
    said = []
    for card in (False, True):
        if card:
            parsed = use_card_standin(monkeypatch)
        with pytest.raises(B.BamFormatError) as e:
            for _ in B.BamStreamReader(bad, target_bytes=SEGS[1],
                                       device="cpu").read()[1]:
                pass
        said.append(str(e.value))
    assert said[0] == said[1] == f"BGZF inflate failed in {bad}"
    assert parsed  # the segments before the bad block were parsed


def parsed_segments(path, seg, keep_bytes):
    """[(batch, tail, last)] of BamStreamReader.parsed over `path`."""
    reader = B.BamStreamReader(path, target_bytes=seg, device="cpu",
                               keep_bytes=keep_bytes)
    return list(reader.parsed(reader._header_at))


@pytest.mark.parametrize("card", [False, True])
@pytest.mark.parametrize("seg", (2048, 5000, 1 << 20))
def test_without_bytes_the_same_columns_and_carries(bam, seg, card,
                                                    monkeypatch):
    """keep_bytes=False, on the host route and on the card route: each
    segment's batch holds the same columns and end as with the bytes,
    data None, the same carry after it; the reader's contig-cut batches
    alike; concat_batches of batches without bytes joins their columns
    as it joins those of batches with them, copying no byte; and the
    readers of whole records (readfilter._mtid, RecordBatch.qnames, the
    pair filter) raise on them."""
    path, n_records = bam
    kept = parsed_segments(path, seg, True)
    kept_batches = list(B.BamStreamReader(path, target_bytes=seg,
                                          device="cpu").read()[1])
    if card:
        use_card_standin(monkeypatch)
    bare = parsed_segments(path, seg, False)
    assert len(bare) == len(kept)
    for (a, ta, la), (b, tb, lb) in zip(bare, kept):
        assert a.data is None and b.data is not None and la == lb
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        np.testing.assert_array_equal(B._as_u8(ta), B._as_u8(tb))
    got = list(B.BamStreamReader(path, target_bytes=seg, device="cpu",
                                 keep_bytes=False).read()[1])
    assert len(got) == len(kept_batches)
    assert sum(b.n_records for b in got) == n_records
    for a, b in zip(got, kept_batches):
        assert a.data is None
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
    pieces = [b for b, _, _ in bare if b.n_records][:4]
    with_bytes = [b for b, _, _ in kept if b.n_records][:4]
    joined, want = B.concat_batches(pieces), B.concat_batches(with_bytes)
    assert joined.data is None and want.data is not None
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(joined, f), getattr(want, f),
                                      err_msg=f)
    for read_whole in (_mtid, lambda b: b.qnames(),
                       lambda b: list(filter_payload(
                           type("Src", (), {})(), iter([b]),
                           FilterParams(min_percent_identity_pair=0.95),
                           FlagFilter()))):
        with pytest.raises(ValueError, match="keep_bytes"):
            read_whole(joined)


GFF_GENES = [(t, s, s + ln) for t in (0, 1, 2, 4)
             for s, ln in ((100, 900), (5000, 2500), (20000, 12000),
                           (40000, 7000))]


@pytest.mark.parametrize("case", ["gff", "pair_filter", "classic_metabat",
                                  "filter", "single_filter", "sharded"])
def test_cli_through_the_card_route_prints_the_jax_bytes(
        bam, tmp_path, monkeypatch, jax_native, case):
    """The routes of the classic reader, the port through the card
    route on the CPU in 8 KiB segments, the JAX package's CLI on the
    same BAM in the same segments: the same TSV, or for `filter` the same
    output BAM and count line. `--gff`, COVERM_TPU_FUSED=0 with `-m
    metabat` and a single-read filter read their batches without the
    bytes; a pair filter, `filter` and `--sharded` (two name-sorted
    shard BAMs, tests/test_torch_mapping.write_shards) with them."""
    from coverm_tpu import cli as jcli
    from coverm_tpu import modes as jmodes
    from coverm_tpu_torch import cli
    from coverm_tpu_torch import modes
    from coverm_tpu_torch.io import native
    path, n_records = bam
    gff = tmp_path / "genes.gff"
    gff.write_text("".join(f"c{t}\tt\tgene\t{s + 1}\t{e}\t.\t+\t.\t"
                           f"ID=g{k}\n"
                           for k, (t, s, e) in enumerate(GFF_GENES)))
    methods = ["-m", "mean", "trimmed_mean", "covered_fraction", "count"]
    argv = {
        "gff": ["contig", "--gff", str(gff), "-b", path, *methods],
        "pair_filter": ["contig", "-b", path, *methods,
                        "--min-read-percent-identity-pair", "96"],
        "classic_metabat": ["contig", "-b", path, "-m", "metabat"],
        "filter": ["filter", "-b", path, "--min-read-percent-identity-pair",
                   "96"],
        "single_filter": ["contig", "-b", path, *methods,
                          "--min-read-percent-identity", "96"],
        "sharded": ["contig", "--sharded", "-m", "mean", "count", "-b"],
    }[case]
    if case == "sharded":
        from test_torch_mapping import write_shards
        shards = {}
        write_shards(shards, tmp_path, np.random.default_rng(3))
        argv += [shards["s1"], shards["s2"]]
        n_records = 1600  # 400 pairs a shard
    monkeypatch.setenv("COVERM_TPU_SEGMENT_BYTES", str(SEGS[1]))
    if case in ("classic_metabat", "single_filter"):
        monkeypatch.setenv("COVERM_TPU_FUSED", "0")
    monkeypatch.setattr(jmodes, "STREAM_THRESHOLD_BYTES", 1)
    monkeypatch.setattr(modes, "STREAM_THRESHOLD_BYTES", 1)
    outs = [str(tmp_path / "jax.out"), str(tmp_path / "port.out")]
    host_parse = native.parse_records_full
    parsed = use_card_standin(monkeypatch)
    if case == "sharded":
        # the merge's external sorter parses its spilled buckets on the
        # host: only the shards' reading must take the card route
        monkeypatch.setattr(native, "parse_records_full", host_parse)
    kept = []  # each of the port's readers: did it keep the bytes?
    init = B.BamStreamReader.__init__

    def noting(self, *args, **kwargs):
        init(self, *args, **kwargs)
        kept.append(self.keep_bytes)
    monkeypatch.setattr(B.BamStreamReader, "__init__", noting)
    said = []
    for run, out in ((lambda a: jcli.main(a), outs[0]),
                     (lambda a: cli.main(a, device="cpu"), outs[1])):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert run(argv + ["-o", out]) in (0, None)
        said.append([line for line in err.getvalue().splitlines()
                     if line.startswith("In sample")])
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        want = a.read()
        assert b.read() == want
    # a row a contig or gene, or the filtered BAM's records
    assert len(want) > 1000 if case == "filter" else \
        want.count(b"\n") >= 6
    assert said[0] == said[1]
    assert sum(parsed) == n_records
    whole = case in ("pair_filter", "filter", "sharded")
    assert kept and set(kept) == {whole}, kept
