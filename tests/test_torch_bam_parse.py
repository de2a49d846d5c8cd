"""The card's record parse (ops/bam_scan.parse_segment, the parse steps of
csrc/bam_scan.cu) on the CPU: the classic record reader's columns.

One segment's inflated bytes are parsed three ways and held column for
column, every integer column exactly, against the port's host parse
(io/bam.parse_records: native parse_records_full) and the JAX package's
(coverm_tpu.io.bam.parse_records, on its own native library):

- the kernels' source built for the host by g++ (bam_scan_host: each
  step through the kernels' own functions), driven by the wrapper's own
  step sequence (run_parse_steps);
- the plain version (bam_parse_reference);
- parse_segment on a CPU tensor (which takes the plain version).

Held equal: every record column and the blocks (block_read, start, end)
with their types, where the complete records end, and on malformed input
the exception's class and message (BamFormatError from the host's
parallel decode, ValueError where its geometry check sends it to the
fallback walk) with the same record index. The inputs: the record scan's
streams and test BAMs (tests/test_torch_bam_scan.py), seeded
coverm_tpu_torch.synth samples cut at several ends, and streams written
record by record: records across every 64 KiB region boundary, a CIGAR
of 20,000 operations, names of one byte and none, NM and AS missing or
of every integer type (and NM twice, which ends the search), N, S, H and
P operations and codes above 8, a truncated last record, block_size
under 33 (32 with no name or CIGAR, which the host parses, and shorter
ones, which it refuses), a negative l_seq, a corrupt l_read_name and
malformed or truncated aux tags, errors on either side of a region
boundary, reads of 1,500 to 6,000 bases whose records run past the
parse's staged window, and the record scan's streams (long reads,
forged headers, regions the stitch walks, whose starts the parse walks
too). Without the bytes (keep_bytes=False) the columns, the end and the
carry are the same and no bytes come back; the arena's layout and the
pinned pool's reuse are held too.

On the card (`python -m pytest --noconftest -m cuda
tests/test_torch_bam_parse.py`) the kernels must equal the plain version
and the host parse on the same streams, one launch counted a parse, and
each parse copies its arena back in one copy (one more for the bytes).
This file imports the JAX package only inside its CPU tests.
"""

import importlib
import struct

import numpy as np
import pytest
import torch

from coverm_tpu_torch.io import bam as B
from coverm_tpu_torch.io import native
from coverm_tpu_torch.ops import bam_scan as S

from test_torch_bam_scan import STREAMS as SCAN_STREAMS
from test_torch_bam_scan import host_kernels  # noqa: F401

N_REF = 6
INT_TYPES = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
             "I": "<I"}


def _tests_module(name):
    return importlib.import_module(name)


def tag(name, typ, value):
    """One aux tag's bytes."""
    if typ in INT_TYPES:
        return name + typ.encode() + struct.pack(INT_TYPES[typ], value)
    if typ == "A":
        return name + b"A" + bytes([value])
    if typ == "Z":
        return name + b"Z" + value + b"\0"
    if typ == "f":
        return name + b"f" + struct.pack("<f", value)
    raise ValueError(typ)


def rec(tid, pos, flag=0, cigar=((0, 50),), l_seq=50, name=b"q",
        aux=b"", mapq=30, l_read_name=None, l_seq_field=None,
        block_size=None):
    """One BAM record's bytes (block_size first). l_read_name 0 writes no
    name bytes at all."""
    name = name + b"\0" if l_read_name != 0 else b""
    seq = bytes((l_seq + 1) // 2) + bytes([20]) * l_seq
    body = struct.pack("<iiBBHHHiiii", tid, pos,
                       len(name) if l_read_name is None else l_read_name,
                       mapq, 4680, len(cigar), flag,
                       l_seq if l_seq_field is None else l_seq_field,
                       tid, pos + 100, 150)
    body += name + b"".join(struct.pack("<I", ln << 4 | op)
                            for op, ln in cigar) + seq + aux
    bs = len(body) if block_size is None else block_size
    return struct.pack("<I", bs) + body


def tags_of(j):
    """NM and AS of record j: absent, or of each integer type in turn,
    in either order, among other tags."""
    t = list(INT_TYPES)
    k = j % 9
    nm = b"" if k == 7 else tag(b"NM", t[j % 6], (j * 7) % 100)
    as_ = b"" if k == 8 else tag(b"AS", t[(j // 6) % 6], (j * 13) % 120)
    other = tag(b"XA", "A", 65) + tag(b"RG", "Z", b"grp%d" % (j % 4)) \
        + tag(b"XF", "f", 0.5)
    return [nm + as_ + other, other + as_ + nm, as_ + other + nm][j % 3]


CIGARS = [((0, 50),), ((4, 5), (0, 40), (5, 5)), ((0, 20), (1, 2),
                                                  (0, 10), (2, 3),
                                                  (0, 18)),
          ((0, 10), (3, 200), (7, 30), (8, 10)), ((6, 2), (0, 50)),
          ((0, 25), (9, 4), (15, 1), (0, 25))]


def mixed(n, seed, start_tid=0):
    """n sorted records: every CIGAR kind, names of 1 to 20 bytes, NM and
    AS of every integer type or missing, unmapped and secondary ones."""
    rng = np.random.default_rng(seed)
    tids = np.sort(rng.integers(start_tid, N_REF, n))
    out = []
    for j in range(n):
        cig = CIGARS[j % len(CIGARS)]
        l_seq = sum(ln for op, ln in cig if op in (0, 1, 4, 7, 8))
        flag = int(rng.choice([0, 16, 99, 147, 256, 2048, 4]))
        name = b"r%d" % j if j % 5 else b"x" * (1 + j % 20)
        out.append(rec(int(tids[j]), j * 3, flag, cig, l_seq, name,
                       tags_of(j)))
    return out


def _join(recs):
    return np.frombuffer(b"".join(recs), np.uint8).copy()


def long_cigar():
    cig = tuple((0, 3) if k % 2 == 0 else (2, 1) for k in range(20000))
    return [rec(2, 10, 0, cig, 30000, b"cigar", tags_of(1))]


def long_reads(n=300, seed=31):
    """n sorted records of 1,500 to 6,000 bases (2.3 to 9 KiB), so that
    the last records of many regions run past the parse's window of the
    region (S.STAGE bytes)."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        ln = int(rng.choice([1500, 3000, 6000]))
        cig = ((0, ln // 2), (1, 3), (0, ln - ln // 2 - 3))
        out.append(rec(j * N_REF // n, j * 11, 0, cig, ln, b"long%d" % j,
                       tags_of(j)))
    return out


STREAMS = {
    "mixed": lambda: _join(mixed(4000, 1)),  # over four 64 KiB regions
    "long_cigar": lambda: _join(mixed(300, 2) + long_cigar()
                                + mixed(300, 3, 2)),
    "names": lambda: _join([rec(0, j, name=b"" if j % 2 else b"a",
                                aux=tags_of(j)) for j in range(500)]),
    "nm_twice": lambda: _join(mixed(50, 4) + [
        rec(3, 1, aux=tag(b"NM", "C", 2) + tag(b"NM", "i", 9)
            + tag(b"AS", "i", 40))] + mixed(50, 5, 3)),
    "truncated_last": lambda: _join(mixed(900, 6))[:-29],
    "zero_block_size": lambda: _join(
        mixed(700, 7) + [struct.pack("<I", 0) + bytes(60)] + mixed(5, 8)),
    "block_size_32_parsed": lambda: _join(
        mixed(300, 9) + [rec(2, 5, cigar=(), l_seq=0, name=b"",
                             l_read_name=0)] + mixed(300, 10, 2)),
    "block_size_32_refused": lambda: _join(
        mixed(300, 11) + [rec(2, 5, cigar=(), l_seq=0, name=b"",
                              l_read_name=3, block_size=32)]
        + mixed(30, 12)),
    "block_size_under_32": lambda: _join(
        mixed(800, 13) + [struct.pack("<I", 20) + bytes(20)]
        + mixed(50, 14)),
    "negative_l_seq": lambda: _join(
        mixed(400, 15) + [rec(1, 1, l_seq_field=-4)] + mixed(20, 16)),
    "corrupt_l_read_name": lambda: _join(
        mixed(400, 17) + [rec(1, 1, l_read_name=250)] + mixed(20, 18)),
    "bad_aux_type": lambda: _join(
        mixed(300, 19) + [rec(5, 2, aux=b"XXq\x01NMC\x01")]),
    "truncated_aux": lambda: _join(
        mixed(300, 20) + [rec(5, 2, aux=tag(b"XA", "A", 1) + b"NMi\x01")]
        + mixed(10, 21, 5)),
    "bad_then_corrupt": lambda: _join(
        mixed(200, 22) + [rec(1, 1, l_seq_field=-1)] + mixed(100, 23)
        + [rec(4, 1, l_read_name=250)] + mixed(20, 24, 4)),
    "long_reads": lambda: _join(long_reads()),
}
# the record scan's streams (tests/test_torch_bam_scan.py): records of up
# to 1,200 and of 90,000 and 150,000 bases, headers forged into quality
# bytes and a B array (a stream that the host's parse refuses at its
# first record, and so must the kernels), and regions the stitch has to
# walk (from region 1, from several)
for _name in ("sorted", "forged", "long", "walk_from_region_1",
              "walk_from_several_regions"):
    STREAMS["scan_" + _name] = SCAN_STREAMS[_name]
# the streams the host parses whole
PARSED = ("mixed", "long_cigar", "names", "nm_twice", "truncated_last",
          "zero_block_size", "block_size_32_parsed", "long_reads",
          "scan_sorted", "scan_long", "scan_walk_from_region_1",
          "scan_walk_from_several_regions")


def region_1_first():
    """The index of the first record of region 1 in error_near_region's
    stream."""
    sizes = np.cumsum([len(rec(0, j, aux=tags_of(j))) for j in range(1500)])
    return int(np.searchsorted(sizes, S.REGION, side="right"))


def error_near_region(k):
    """1,500 records, record k (the first of region 1, or the last of
    region 0) with a malformed aux tag."""
    out = [rec(0, j, aux=tags_of(j)) for j in range(1500)]
    out[k] = rec(0, k, aux=b"XXq\x01" + tags_of(k))
    return _join(out)


STREAMS["error_before_region_1"] = lambda: error_near_region(
    region_1_first() - 1)
STREAMS["error_after_region_1"] = lambda: error_near_region(
    region_1_first())


# ---- the parses, as one outcome each

def columns_of(batch, end_off):
    cols = {name: getattr(batch, name) for name, _ in S.PARSE_COLUMNS}
    cols.update({name: getattr(batch, name) for name in S.BLOCK_COLUMNS})
    return cols, int(end_off)


def outcome_host(data, start, end, mod=B):
    """io/bam.parse_records' outcome: (columns, end_off), or (error class
    name, message)."""
    try:
        batch, end_off = mod.parse_records(data, start, end)
    except Exception as e:  # the class is part of the outcome
        return type(e).__name__, str(e)
    return columns_of(batch, end_off)


def outcome_parse(fn):
    try:
        ps = fn()
    except Exception as e:  # the class is part of the outcome
        return type(e).__name__, str(e)
    return ps.columns, ps.end_off


def assert_same(got, want):
    if isinstance(want[0], str):
        assert got == want
        return
    assert not isinstance(got[0], str), got
    assert got[1] == want[1]
    assert got[0].keys() == want[0].keys()
    for k, v in want[0].items():
        g = np.asarray(got[0][k])
        assert g.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)


def parses(data, start, end, n_ref, launch):
    """{way: outcome} of the kernels' host build, the plain version and
    parse_segment on a CPU tensor."""
    t = torch.from_numpy(data)
    return {
        "kernels": outcome_parse(lambda: S.run_parse_steps(
            t, start, end, n_ref, launch)),
        "plain": outcome_parse(lambda: S.bam_parse_reference(
            t, start, end, n_ref)),
        "parse_segment": outcome_parse(lambda: S.parse_segment(
            t, start, end, n_ref)),
    }


@pytest.fixture(scope="module")
def jax_native_loaded():
    _tests_module("test_torch_native_build").load_jax_native()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_streams_equal_the_host_parse(host_kernels, jax_native_loaded,
                                      name):
    from coverm_tpu.io import bam as jbam
    data = STREAMS[name]()
    want = outcome_host(data, 0, data.size)
    assert_same(outcome_host(data, 0, data.size, jbam), want)
    for way, out in parses(data, 0, data.size, N_REF,
                           host_kernels).items():
        assert_same(out, want)
    ok = not isinstance(want[0], str)
    assert ok == (name in PARSED), want
    if name == "mixed":
        assert data.size > 3 * S.REGION and want[0]["block_read"].size
    if name == "block_size_32_parsed":
        assert 32 in (want[0]["rec_end"] - want[0]["rec_start"] - 4)


def test_errors_are_the_host_parses(jax_native_loaded):
    """The malformed streams' outcomes, as the host gives them: the first
    bad record, BamFormatError from the parallel decode and ValueError
    where a record of corrupt geometry sends the host to its fallback
    walk."""
    said = {name: outcome_host(STREAMS[name](), 0, STREAMS[name]().size)
            for name in STREAMS}
    assert said["bad_aux_type"] == ("BamFormatError", S.BAD_RECORD.format(
        300))
    assert said["truncated_aux"] == ("BamFormatError",
                                     S.BAD_RECORD.format(300))
    assert said["negative_l_seq"] == ("BamFormatError",
                                      S.BAD_RECORD.format(400))
    for name, k in (("corrupt_l_read_name", 400),
                    ("block_size_under_32", 800),
                    ("block_size_32_refused", 300),
                    ("bad_then_corrupt", 200)):
        assert said[name] == ("ValueError", S.BAD_RECORD.format(k)), name
    k = region_1_first()
    assert said["error_before_region_1"] == ("BamFormatError",
                                             S.BAD_RECORD.format(k - 1))
    assert said["error_after_region_1"] == ("BamFormatError",
                                            S.BAD_RECORD.format(k))
    data = STREAMS["zero_block_size"]()
    assert said["zero_block_size"][1] < data.size - 4
    data = STREAMS["truncated_last"]()
    assert said["truncated_last"][1] < data.size
    cols = said["nm_twice"][0]
    assert cols["nm"][50] == 9 and cols["as_score"][50] == S.AS_MISSING


@pytest.mark.parametrize("cut", [0, 1, 3, 36, 5000, 70000])
def test_every_end_equals_the_host_parse(host_kernels, cut):
    """The same stream ended short of its end: the parse stops where the
    host's does."""
    data = STREAMS["long_cigar"]()
    end = data.size - cut
    want = outcome_host(data, 0, end)
    for out in parses(data, 0, end, N_REF, host_kernels).values():
        assert_same(out, want)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A seeded synth sample of two chunks' worth of records, inflated:
    (bytes, the records' start, n_ref)."""
    from coverm_tpu_torch.synth import write_sorted_bam
    path = str(tmp_path_factory.mktemp("parse") / "synth.bam")
    write_sorted_bam(path, n_contigs=4, contig_len=200_000, seed=7)
    mm = np.fromfile(path, np.uint8)
    off, csz, usz = native.bgzf_scan(mm)
    data = native.bgzf_inflate_blocks(mm, off, csz, usz)
    header, start = B._parse_header(data)
    return data, start, header.n_ref


@pytest.mark.parametrize("frac", [1.0, 0.73, 0.5, 0.21])
def test_synth_sample_cut_at_several_ends(host_kernels, jax_native_loaded,
                                          synth, frac):
    from coverm_tpu.io import bam as jbam
    data, start, n_ref = synth
    end = start + int((data.size - start) * frac)
    want = outcome_host(data, start, end)
    assert_same(outcome_host(data, start, end, jbam), want)
    for out in parses(data, start, end, n_ref, host_kernels).values():
        assert_same(out, want)
    assert want[0]["tid"].size > (20_000 if frac > 0.5 else 1)


@pytest.mark.parametrize("name", ["scan_mixed", "scan_unsorted",
                                  "scan_no_nm", "filter_cases"])
def test_scan_bams_equal_the_host_parse(host_kernels, jax_native_loaded,
                                        tmp_path, name):
    """The record scan's test BAMs (tests/test_torch_scan.py and
    tests/test_torch_fused_filter.py), whole and cut in the middle."""
    from coverm_tpu.io import bam as jbam
    writer, kw = {"scan_mixed": ("test_torch_scan", {}),
                  "scan_unsorted": ("test_torch_scan", {"bad_sort": True}),
                  "scan_no_nm": ("test_torch_scan", {"drop_nm": True}),
                  "filter_cases": ("test_torch_fused_filter", {})}[name]
    path = _tests_module(writer).write_bam(str(tmp_path / "x.bam"), **kw)
    mm = np.fromfile(path, np.uint8)
    off, csz, usz = native.bgzf_scan(mm)
    data = native.bgzf_inflate_blocks(mm, off, csz, usz)
    header, start = B._parse_header(data)
    for end in (data.size, (data.size + start) // 2):
        want = outcome_host(data, start, end)
        assert_same(outcome_host(data, start, end, jbam), want)
        for out in parses(data, start, end, header.n_ref,
                          host_kernels).values():
            assert_same(out, want)


def test_offsets_count_from_base_and_bytes_come_back():
    """base shifts the offsets and keep_bytes returns data[base:end], as
    the reader's card route takes them."""
    data = STREAMS["mixed"]()
    pad = np.zeros(1000, np.uint8)
    t = torch.from_numpy(np.concatenate([pad, data]))
    ps = S.parse_segment(t, 1000, t.numel(), N_REF, base=1000,
                         keep_bytes=True)
    want = outcome_host(data, 0, data.size)
    assert_same((ps.columns, ps.end_off), want)
    np.testing.assert_array_equal(ps.data, data)


def window_crossings(cols):
    """How many records run past their region's parse window."""
    start = cols["rec_start"]
    return int((cols["rec_end"] > start // S.REGION * S.REGION
                + S.STAGE).sum())


def test_records_cross_the_window_and_regions_are_walked(host_kernels):
    """The streams reach the parse's two slow paths: records read whole
    from device memory past the window (long_reads, the scan's long
    stream), and regions whose starts the parse walks from their entry,
    because the stitch walked them (the forged streams)."""
    for name, least in (("long_reads", 10), ("scan_long", 1)):
        data = STREAMS[name]()
        ps = S.run_parse_steps(torch.from_numpy(data), 0, data.size, N_REF,
                               host_kernels)
        assert window_crossings(ps.columns) >= least, name
    for name in ("scan_walk_from_region_1",
                 "scan_walk_from_several_regions"):
        data = STREAMS[name]()
        ps = S.run_parse_steps(torch.from_numpy(data), 0, data.size, N_REF,
                               host_kernels)
        assert ps.stitch[4] > 0, name  # regions walked again
    # a region of more than 256 records (the emit's tiles) and of more
    # than kBlkStage blocks (stored unstaged), and one of fewer (staged)
    cols = outcome_host(STREAMS["mixed"](), 0, STREAMS["mixed"]().size)[0]
    per_region = np.bincount(cols["rec_start"] // S.REGION)
    blocks = np.bincount(cols["rec_start"][cols["block_read"]] // S.REGION)
    assert per_region.max() > 256 and blocks.max() > 512
    assert (blocks < 512).any()


@pytest.mark.parametrize("name", ["mixed", "long_reads", "truncated_last",
                                  "zero_block_size", "scan_walk_from_region_1",
                                  "block_size_32_parsed"])
def test_without_the_bytes_the_columns_and_carry_are_the_same(host_kernels,
                                                              name):
    """keep_bytes=False gives the same columns and end_off, data None and
    the same carry (tail: the bytes after end_off), from the kernels'
    host build, the plain version and parse_segment; keep_bytes=True the
    bytes from base."""
    data = STREAMS[name]()
    pad = np.arange(1000, dtype=np.uint8)
    t = torch.from_numpy(np.concatenate([pad, data]))
    ways = {
        "kernels": lambda keep: S.run_parse_steps(
            t, 1000, t.numel(), N_REF, host_kernels, base=1000,
            keep_bytes=keep),
        "plain": lambda keep: S.bam_parse_reference(
            t, 1000, t.numel(), N_REF, 1000, keep),
        "parse_segment": lambda keep: S.parse_segment(
            t, 1000, t.numel(), N_REF, base=1000, keep_bytes=keep),
    }
    want = outcome_host(data, 0, data.size)
    for way, fn in ways.items():
        kept, bare = fn(True), fn(False)
        assert bare.data is None, way
        for ps in (kept, bare):
            assert_same((ps.columns, ps.end_off), want)
            np.testing.assert_array_equal(ps.tail, data[want[1]:],
                                          err_msg=way)
        np.testing.assert_array_equal(kept.data, data, err_msg=way)


def test_arena_layout_and_the_pinned_pool():
    """The arena's columns lie apart, each from a multiple of
    ARENA_ALIGN, in PARSE_COLUMNS, BLOCK_COLUMNS and tail order; the pool
    hands a buffer out again only once no array of its last lease is
    alive, and counts one copy for the arena and one for the bytes."""
    import gc
    layout, size = S.arena_layout(1001, 2003, 77)
    names = [n for n, _ in S.PARSE_COLUMNS] + list(S.BLOCK_COLUMNS)
    assert list(layout) == names + ["tail"]
    end = 0
    for name, (at, count, dtype) in layout.items():
        assert at % S.ARENA_ALIGN == 0 and at >= end, name
        end = at + count * dtype.itemsize
        assert count == {"tail": 77, **dict.fromkeys(
            S.BLOCK_COLUMNS, 2003)}.get(name, 1001)
    assert end <= size < end + S.ARENA_ALIGN
    pool = S.PinnedPool(pin=False)
    arena = torch.arange(4096, dtype=torch.int64).view(torch.uint8)
    lease, kept = pool.copy_back(arena)
    col = np.frombuffer(lease, np.int64, 512, 0)
    np.testing.assert_array_equal(col, np.arange(512))
    assert kept is None and pool.copies == 1 and pool.allocated == 1
    del lease
    gc.collect()
    raw = torch.arange(100, dtype=torch.uint8)
    lease2, kept2 = pool.copy_back(arena, raw)  # col alive: a new buffer
    assert pool.allocated == 2 and pool.copies == 3
    np.testing.assert_array_equal(kept2, np.arange(100))
    np.testing.assert_array_equal(col, np.arange(512))
    del col, lease2, kept2
    gc.collect()
    pool.copy_back(arena)  # both free again: no new buffer
    assert pool.allocated == 2 and pool.copies == 4
    gc.collect()
    big = torch.zeros(1 << 20, dtype=torch.uint8)
    lease3, _ = pool.copy_back(big)  # too large for both: they go
    assert pool.allocated == 3 and len(pool._slots) == 1
    assert np.frombuffer(lease3, np.uint8).size == 1 << 20


def test_parse_bytes_read_leaves_out_sequences():
    """The bound's byte count (chip_smoke.py's bam_parse bound_ms): the
    sectors of the fixed fields, names, CIGARs and aux tags up to NM and
    AS; more than the scan's, less than every byte."""
    data = _join(mixed(3000, 30))
    t = torch.from_numpy(data)
    got = S.parse_bytes_read(t, 0, data.size, N_REF)
    scan = S.bytes_read(t, 0, data.size, N_REF, 0, 0)
    assert scan < got < data.size


def test_wrapper_checks_its_input():
    with pytest.raises(ValueError, match="uint8"):
        S.parse_segment(torch.zeros(8, dtype=torch.int32), 0, 8, 1)
    with pytest.raises(ValueError, match="within"):
        S.parse_segment(torch.zeros(8, dtype=torch.uint8), 0, 9, 1)
    empty = S.parse_segment(torch.zeros(3, dtype=torch.uint8), 0, 3, 1)
    assert empty.n_records == 0 and empty.end_off == 0
    assert empty.columns["block_read"].size == 0
    assert set(empty.columns) == {n for n, _ in S.PARSE_COLUMNS} | set(
        S.BLOCK_COLUMNS)


# ---- on the card

@pytest.mark.cuda
def test_cuda_parse_equals_plain_and_host(tmp_path):
    """The kernels on the card against the plain version and the host
    parse, on every stream and on a bench-shaped BAM, and one launch
    counted a parse."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from coverm_tpu_torch.synth import write_sorted_bam
    dev = torch.device("cuda")
    cases = [(STREAMS[name](), 0, N_REF) for name in sorted(STREAMS)]
    bam = str(tmp_path / "bench.bam")
    write_sorted_bam(bam, n_contigs=4, contig_len=300_000)
    mm = np.fromfile(bam, np.uint8)
    off, csz, usz = native.bgzf_scan(mm)
    data = native.bgzf_inflate_blocks(mm, off, csz, usz)
    header, start = B._parse_header(data)
    cases.append((data, start, header.n_ref))
    for data, start, n_ref in cases:
        want = outcome_host(data, start, data.size)
        before = S.bam_parse_launches
        on_card = torch.from_numpy(data).to(dev)
        got = outcome_parse(lambda: S.parse_segment(
            on_card, start, data.size, n_ref, timing=True))
        torch.cuda.synchronize()
        plain = outcome_parse(lambda: S.bam_parse_reference(
            torch.from_numpy(data), start, data.size, n_ref))
        assert_same(got, want)
        assert_same(plain, want)
        if not isinstance(want[0], str):
            assert S.bam_parse_launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [False, True])
def test_cuda_one_arena_copy_a_segment(keep):
    """On the card each parse copies back its arena in one copy (and with
    keep_bytes the slot's bytes in one more) into the module's pinned
    pool, whose buffers come back into use; the columns and the carry are
    the plain version's, the bytes data's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import gc
    dev = torch.device("cuda")
    for name in ("mixed", "long_reads", "scan_walk_from_several_regions",
                 "truncated_last"):
        data = STREAMS[name]()
        on_card = torch.from_numpy(data).to(dev)
        plain = S.bam_parse_reference(torch.from_numpy(data), 0, data.size,
                                      N_REF, keep_bytes=keep)
        copies = S._PINNED.copies
        got = S.parse_segment(on_card, 0, data.size, N_REF, keep_bytes=keep)
        assert S._PINNED.copies == copies + 1 + keep, name
        assert_same((got.columns, got.end_off),
                    (plain.columns, plain.end_off))
        np.testing.assert_array_equal(got.tail, plain.tail)
        if keep:
            np.testing.assert_array_equal(got.data, data)
        else:
            assert got.data is None
        del got
        gc.collect()
    allocated = S._PINNED.allocated
    for _ in range(3):  # the same segment again: a buffer reused
        S.parse_segment(on_card, 0, data.size, N_REF, keep_bytes=keep)
        gc.collect()
    assert S._PINNED.allocated == allocated
