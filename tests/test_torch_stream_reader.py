"""The port's classic record reader (io/bam.BamStreamReader) parses every
record once, on the CPU.

The BAM's first contig and its unplaced unmapped tail each span dozens
of 8 KiB segments. parse_records must see exactly the file's records;
the batches must stay contig-disjoint and, record for record, hold what
the JAX package's reader yields (which parses a held contig again with
every segment), the unplaced tail apart, which the port now yields as it
comes; the raw bytes behind rec_start/rec_end must be the records', and
the classic scan (filtered and not) must equal the JAX package's; seed 0.
"""

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
    _, gen = B.BamStreamReader(path, target_bytes=seg).read()
    got = list(gen)
    assert sum(seen) == n_records
    assert sum(b.n_records for b in got) == n_records
    if seg < 1 << 20:
        assert len(seen) > 50  # the stream spans many segments


@pytest.mark.parametrize("seg", SEGS)
def test_batches_hold_the_jax_readers_records(bam, seg):
    path, _ = bam
    _, gen = B.BamStreamReader(path, target_bytes=seg).read()
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
    _, gen = B.BamStreamReader(path, target_bytes=SEGS[1]).read()
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
    h = B.BamStreamReader(path).read()[0]
    got = T.scan_sample_batches(h, gen, ReferenceLayout.build(
        h.target_lens, EE), FlagFilter(), False, device="cpu")
    want = j_scan_batches(h, jgen, JLayout.build(h.target_lens, EE),
                          JFlagFilter(), False)
    assert int(got.reads_all.sum()) > 0
    assert_scans_equal(got, want)
