"""The card's BAM record scan (coverm_tpu_torch/ops/bam_scan.py,
csrc/bam_scan.cu) on the CPU.

One segment's inflated bytes are scanned three ways and held bit for bit
against the host scan, the port's native.stats_scan (ct_stats_scan), and
against the JAX package's coverm_tpu.io.native.stats_scan:

- the kernels' source built for the host by g++ (bam_scan_host: each
  step through the kernels' own functions, a block's threads one after
  another and its scans as loops), driven by the wrapper's own step
  sequence (run_steps);
- the plain version (bam_scan_reference), which the wrapper takes for a
  CPU tensor.

Held equal: the blocks (tid, start, end) in record order, the per-contig
block counts, every StatsAccum field after the runs are added (the
float64 identity sums included, by np.array_equal), the scalars
(records, end_off, primary alignments, NM-less records, sortedness,
first and last tid), and on malformed input the same ValueError message
with the same record index. The inputs: CoverM's test BAMs
where the reference data is mounted (tests/conftest.py's
REFERENCE_DATA), the test BAMs of
test_torch_scan.py and test_torch_fused_filter.py and seeded
coverm_tpu_torch.synth samples (more than one 32,768-record chunk),
unfiltered and under -m metabat's single-read filter, cut at several
ends; and streams written record by record for the speculation and the
stitch: records across every 64 KiB region boundary, records longer than
a region (long reads, a CIGAR of 20,000 operations), quality and aux
bytes forged into plausible headers, a truncated last record, a zero
block_size, block_size < 33, unsorted input, NM missing, tid out of range
and a corrupt l_read_name; for the fold's block scans and float64
chains, a chunk whose every counted record starts a run, errors at the
first and last record of a chunk and at records 32,767 and 32,768, a
chunk with no counted record, and identity terms of +0.0 and below zero
(whose runs' words must also equal the plain fold's); for the stitch's
parallel check, headers forged so that it stops at region 1, in the
middle, at the last region and at several regions apart (where its walk
must start).

A whole `contig -b` through the card route with a CPU stand-in for the
card slot (SegmentInflater on the CPU, whose tensors send the scan to the
plain version) prints the JAX package's TSV.

On the card (`python -m pytest --noconftest -m cuda
tests/test_torch_bam_scan.py`) the kernels must equal the plain version
and the host scan on the same streams.
"""

import ctypes
import importlib
import os
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

from coverm_tpu_torch.io import native
from coverm_tpu_torch.io.bam import _parse_header
from coverm_tpu_torch.ops import bam_scan as S

N_REF = 6
SKIP, REQ = 0x100, 0  # the default flag filter's masks: no secondary


def _tests_module(name):
    """A sibling test module (they import the JAX package, so not at the
    top of this one, whose cuda case runs where JAX is absent)."""
    return importlib.import_module(name)


# ---- streams written record by record

def record(tid, pos, flag=0, cigar=((0, 100),), l_seq=100, nm=1, mapq=60,
           name=b"r", qual=None, aux=b"", next_ref=-1, l_read_name=None,
           block_size=None):
    """One BAM record's bytes (block_size first)."""
    name = name + b"\0"
    seq = bytes((l_seq + 1) // 2)
    qual = bytes([30]) * l_seq if qual is None else qual
    assert len(qual) == l_seq
    tags = (b"NMC" + bytes([nm]) if nm is not None else b"") + aux
    body = struct.pack("<iiBBHHHiiii", tid, pos,
                       len(name) if l_read_name is None else l_read_name,
                       mapq, 4680, len(cigar), flag, l_seq, next_ref, -1, 0)
    body += name + b"".join(struct.pack("<I", ln << 4 | op)
                            for op, ln in cigar) + seq + qual + tags
    bs = len(body) if block_size is None else block_size
    return struct.pack("<I", bs) + body


def sorted_stream(n, seed, sizes=(60, 150, 400, 1200)):
    """n sorted mapped records of varied lengths, NM 0-5, some secondary,
    supplementary and unmapped."""
    rng = np.random.default_rng(seed)
    tids = np.sort(rng.integers(0, N_REF, n))
    out = []
    for j in range(n):
        ln = int(rng.choice(sizes))
        flag = int(rng.choice([0, 0, 16, 256, 2048, 4]))
        cig = ((0, ln // 2), (1, 2), (0, ln // 2 - 2), (2, 3), (4, 5)) \
            if j % 3 else ((0, ln),)
        out.append(record(int(tids[j]), j * 7, flag, cig, ln,
                          nm=int(rng.integers(0, 6)),
                          name=b"r%d" % j))
    return out


def forged_stream(n, seed):
    """Records whose quality bytes and a B-array tag each hold a whole
    plausible record, so that a region boundary inside them finds a
    false candidate first."""
    rng = np.random.default_rng(seed)
    fake = record(1, 5, 0, ((0, 40),), 40, name=b"fake")
    out = []
    for j in range(n):
        ln = 300
        qual = (fake * 8)[:ln]
        arr = b"XBC" + struct.pack("<I", len(fake) * 3) + fake * 3
        out.append(record(j * N_REF // n, j, 0, ((0, ln),), ln,
                          nm=int(rng.integers(0, 3)), qual=qual, aux=arr,
                          name=b"q%d" % j))
    return out


def long_stream():
    """Short records around one of 150,000 bases (longer than two
    regions) and one whose CIGAR has 20,000 operations."""
    cig = tuple((0, 3) if k % 2 == 0 else (2, 1) for k in range(20000))
    return (sorted_stream(300, 3)[:150]
            + [record(2, 10, 0, ((0, 150000),), 150000, name=b"long"),
               record(3, 10, 0, cig, 30000, name=b"cigar")]
            + [record(4, j, 0) for j in range(400)]
            + [record(5, 9, 0, ((0, 90000), (4, 10)), 90010, name=b"l2")])


def _join(recs):
    return np.frombuffer(b"".join(recs), np.uint8).copy()


def small(tid, pos, **kw):
    """A short record: 10 bases, one CIGAR operation (61 bytes)."""
    return record(tid, pos, cigar=((0, 10),), l_seq=10, name=b"s", **kw)


def every_record_a_run(n=33000):
    """More than a chunk of records whose every counted record starts a
    run: the tids cycle 0, 5, 4, ... (unsorted), every seventh record
    unmapped and every eleventh secondary (not counted)."""
    out = []
    for j in range(n):
        flag = 4 if j % 7 == 3 else 256 if j % 11 == 5 else 0
        out.append(small((j * 5) % N_REF, j, flag=flag, nm=j % 3))
    return out


def error_at(k, n):
    """n sorted short records, record k with a corrupt l_read_name (an
    error the filter cannot drop)."""
    return [small(j * N_REF // n, j, l_read_name=250) if j == k
            else small(j * N_REF // n, j, nm=j % 2) for j in range(n)]


def uncounted_chunk():
    """A chunk of counted records, then a whole chunk of unmapped and
    secondary ones (no run), then counted ones again."""
    head = [small(j * 3 // S.CHUNK, j, nm=0) for j in range(S.CHUNK)]
    gap = [small(-1, -1, flag=4) if j % 2 else small(3, j, flag=256)
           for j in range(S.CHUNK)]
    return head + gap + [small(4, j, nm=1) for j in range(300)]


def identities_at_zero():
    """Runs whose identity terms are +0.0 (NM equal to the aligned
    length) or below zero (NM above it), mixed with others: a run of
    +0.0 terms only, one where they cancel to 0.0, and NM missing mixed
    in."""
    out = [small(0, j, nm=10) for j in range(700)]
    for j in range(900):  # +0.2 and -0.2, then NM 10 (a +0.0 term)
        out.append(small(1, j, nm=(8, 12, 10)[j % 3]))
    for j in range(1300):
        out.append(small(2, j, nm=None if j % 9 == 4 else j % 4))
    return out


def forged_at(targets, n_regions=12):
    """Sorted records over n_regions 64 KiB regions, where a record just
    before each region of `targets` spans its boundary, its quality
    bytes holding two whole plausible records just past it: those
    regions' speculation starts on a false header whose chain never
    meets the true one, so the stitch's check cannot settle them."""
    fake = record(1, 5, 0, ((0, 40),), 40, name=b"fake")
    qual = b"\x1e" * 4 + fake * 2 + b"\x1e" * 20
    out, size, j = [], 0, 0

    def add(rec):
        nonlocal size, j
        out.append(rec)
        size += len(rec)
        j += 1

    def plain(extra=-1):  # extra >= 0: a Z tag of 4 + extra bytes
        return record(j * N_REF // 6000, j, 0, ((0, 60),), 60, nm=j % 3,
                      aux=b"XZZ" + b"a" * extra + b"\0" if extra >= 0
                      else b"")
    for b in sorted(targets):
        forger = record(j * N_REF // 6000, j, 0, ((0, len(qual)),),
                        len(qual), qual=qual, name=b"forge")
        q_off = len(forger) - len(qual) - 4  # its quality's first byte
        at = b * S.REGION - q_off - 2  # the boundary 2 bytes into it
        while at - size >= 2 * len(plain()) + 8:
            add(plain())
        pad = at - size - len(plain()) - 4  # a Z tag's 4 bytes and more
        assert pad >= 0
        add(plain(pad))
        assert size == at
        add(forger)
    while size < (n_regions - 1) * S.REGION + S.REGION // 2:
        add(plain())
    return out


STREAMS = {
    "sorted": lambda: _join(sorted_stream(3000, 1)),
    "forged": lambda: _join(forged_stream(1500, 2)),
    "long": lambda: _join(long_stream()),
    "truncated_last": lambda: _join(sorted_stream(900, 4))[:-37],
    "zero_block_size": lambda: _join(
        sorted_stream(700, 5) + [struct.pack("<I", 0) + bytes(60)]
        + sorted_stream(50, 6)),
    "block_size_under_33": lambda: _join(
        sorted_stream(800, 7) + [struct.pack("<I", 20) + bytes(20)]
        + sorted_stream(50, 8)),
    "unsorted": lambda: _join(sorted_stream(500, 9)[::-1]),
    "nm_missing": lambda: _join(
        sorted_stream(600, 10) + [record(5, 1, nm=None)]
        + sorted_stream(10, 11)),
    "tid_out_of_range": lambda: _join(
        sorted_stream(1200, 12) + [record(N_REF, 1)]),
    "corrupt_l_read_name": lambda: _join(
        sorted_stream(400, 13) + [record(1, 1, l_read_name=250)]
        + sorted_stream(20, 14)),
    "bad_aux_type": lambda: _join(
        sorted_stream(300, 15) + [record(5, 2, nm=None,
                                         aux=b"XXq\x01NMC\x01")]),
    # the fold's edges
    "every_record_a_run": lambda: _join(every_record_a_run()),
    "error_at_record_0": lambda: _join(error_at(0, 2000)),
    "error_at_the_last_record": lambda: _join(error_at(1999, 2000)),
    "error_at_record_32767": lambda: _join(error_at(32767, 33000)),
    "error_at_record_32768": lambda: _join(error_at(32768, 33000)),
    "uncounted_chunk": lambda: _join(uncounted_chunk()),
    "identities_at_zero": lambda: _join(identities_at_zero()),
    # the stitch's walk, from the first region its check cannot settle
    "walk_from_region_1": lambda: _join(forged_at([1])),
    "walk_from_the_middle": lambda: _join(forged_at([6])),
    "walk_from_the_last_region": lambda: _join(forged_at([11])),
    "walk_from_several_regions": lambda: _join(forged_at([2, 5, 9])),
}
FORGED = {"walk_from_region_1": [1], "walk_from_the_middle": [6],
          "walk_from_the_last_region": [11],
          "walk_from_several_regions": [2, 5, 9]}


# ---- the three scans, as one outcome each

def outcome_host(data, start, end, n_ref, rf=None, mod=native):
    """The host scan's outcome: (error class, message) or its outputs."""
    acc = mod.StatsAccum(n_ref)
    kw = {} if rf is None else {"read_filter": rf}
    try:
        bt, bs, be, counts, end_off = mod.stats_scan(
            data, start, acc, SKIP, REQ, end=end, **kw)
    except ValueError as e:
        return "ValueError", str(e)
    return _outputs(acc, bt, bs, be, counts, end_off)


def outcome_scan(sc, n_ref):
    """A SegmentScan's outcome, its runs added as the card route adds
    them."""
    acc = native.StatsAccum(n_ref)
    scalars = sc.scalars()
    try:
        native.check_scalars(scalars)
        counts = acc.add_runs(sc.runs)
    except ValueError as e:
        return "ValueError", str(e)
    acc.add_segment(scalars)
    return _outputs(acc, sc.btid, sc.bstart, sc.bend, counts, sc.end_off)


def _outputs(acc, bt, bs, be, counts, end_off):
    out = {k: np.asarray(getattr(acc, k)).copy() for k in (
        "reads_primary", "reads_nonsupp", "reads_all", "nm_sum",
        "indel_sum", "ident_primary", "ident_nonsupp", "observed")}
    out.update(btid=np.asarray(bt), bstart=np.asarray(bs),
               bend=np.asarray(be), counts=np.asarray(counts),
               end_off=int(end_off), n_primary=acc.n_primary,
               nm_missing=acc.nm_missing, n_records=acc.n_records,
               sorted=acc.sorted, last_tid=acc.last_tid)
    return out


def assert_same(got, want):
    if isinstance(want, tuple):
        assert got == want
        return
    assert not isinstance(got, tuple), got
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """csrc/bam_scan.cu built for the host by g++: launch(step, args)."""
    cxx = shutil.which("g++")
    assert cxx, "g++ builds the native library; it must be here"
    lib_path = str(tmp_path_factory.mktemp("host") / "libbam_scan_host.so")
    subprocess.run([cxx, "-O2", "-std=c++17", "-x", "c++", "-shared",
                    "-fPIC", "-o", lib_path, S.SOURCE], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(lib_path)
    lib.bam_scan_host.argtypes = [ctypes.c_int, ctypes.POINTER(S.ScanArgs)]
    S._check_layout(lib)

    def launch(step, args):
        assert lib.bam_scan_host(step, ctypes.byref(args)) == 0
    return launch


def scans(data, start, end, n_ref, host_kernels, rf=None):
    """{way: outcome} of the kernels' host build and the plain version."""
    t = torch.from_numpy(data)
    kernels = S.run_steps(t, start, end, n_ref, SKIP, REQ, rf, host_kernels)
    plain = S.scan_segment(t, start, end, n_ref, SKIP, REQ, rf)
    return {"kernels": outcome_scan(kernels, n_ref),
            "plain": outcome_scan(plain, n_ref)}, kernels, plain


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_streams_equal_the_host_scan(host_kernels, name):
    data = STREAMS[name]()
    want = outcome_host(data, 0, data.size, N_REF)
    got, kernels, plain = scans(data, 0, data.size, N_REF, host_kernels)
    for way, out in got.items():
        assert_same(out, want)
    np.testing.assert_array_equal(kernels.stitch[:4], plain.stitch[:4])
    if name == "sorted":
        assert data.size > 3 * S.REGION and not isinstance(want, tuple)
    if name in ("forged", "long"):
        assert not isinstance(want, tuple)


def test_stream_errors_are_the_host_scans(host_kernels):
    """The malformed streams give the host's message and record index."""
    said = {name: outcome_host(STREAMS[name](), 0, STREAMS[name]().size,
                               N_REF) for name in STREAMS}
    for name in ("block_size_under_33", "tid_out_of_range",
                 "corrupt_l_read_name", "bad_aux_type"):
        assert said[name][0] == "ValueError", name
        assert said[name][1].startswith("Malformed BAM record "), name
    assert said["unsorted"]["sorted"] is False
    assert said["nm_missing"]["nm_missing"] == 1
    data = STREAMS["zero_block_size"]()
    assert said["zero_block_size"]["end_off"] < data.size - 4
    data = STREAMS["truncated_last"]()
    assert said["truncated_last"]["end_off"] < data.size


def test_false_candidates_cost_time_not_answers(host_kernels):
    """On the forged stream the speculation meets the forged headers and
    the stitch walks those regions again; on the plain stream it walks
    none but where a stop falls."""
    data = STREAMS["forged"]()
    _, kernels, plain = scans(data, 0, data.size, N_REF, host_kernels)
    assert kernels.regions_walked == plain.regions_walked > 0
    data = STREAMS["sorted"]()
    _, kernels, _ = scans(data, 0, data.size, N_REF, host_kernels)
    assert kernels.regions_walked <= 1


@pytest.mark.parametrize("name", ["sorted"] + sorted(FORGED))
def test_the_stitch_walks_from_the_first_region_it_cannot_settle(
        host_kernels, name):
    """A false header at the start of a region's speculation stops the
    stitch's parallel check there (F, stitch word 6): the walk starts at
    F, walks each forged region again and goes on in order to the
    chain's last region, and the outputs stay the host scan's (test
    above). On the plain stream the check settles every region."""
    data = STREAMS[name]()
    targets = FORGED.get(name, [])
    _, kernels, plain = scans(data, 0, data.size, N_REF, host_kernels)
    assert kernels.regions_walked == plain.regions_walked == len(targets)
    if not targets:
        assert kernels.stitch[6] == kernels.regions_in_sequence == 0
        return
    last = (data.size - 1) // S.REGION
    assert kernels.stitch[6] == targets[0]
    assert kernels.regions_in_sequence == last - targets[0] + 1


FOLD_STREAMS = ["every_record_a_run", "error_at_record_0",
                "error_at_the_last_record", "error_at_record_32767",
                "error_at_record_32768", "uncounted_chunk",
                "identities_at_zero"]


@pytest.mark.parametrize("name", FOLD_STREAMS)
def test_fold_edges_equal_the_plain_fold(host_kernels, name):
    """The fold's block scans and float64 chains (the kernels' host
    build) against the plain version's record-by-record fold, word for
    word (the runs, their float64 sums as bits, and the chunk words), and
    the edge each stream is built to reach; the host scan's outcome is
    held in test_streams_equal_the_host_scan."""
    data = STREAMS[name]()
    _, kernels, plain = scans(data, 0, data.size, N_REF, host_kernels)
    np.testing.assert_array_equal(kernels.runs, plain.runs)
    np.testing.assert_array_equal(kernels.chunks, plain.chunks)
    c = kernels.chunks
    if name == "every_record_a_run":
        counted = sum(1 for j in range(S.CHUNK) if j % 7 != 3 and j % 11 != 5)
        assert c.shape[0] == 2 and c[0, 6] == counted and c[0, 2] == 0
    elif name.startswith("error_at"):
        k = 1999 if name.endswith("last_record") else int(name.split("_")[-1])
        assert c[k >> S.CHUNK_SHIFT, 5] == (k & (S.CHUNK - 1)) + 1
        assert not c[:k >> S.CHUNK_SHIFT, 5].any()
        if k == 0:
            assert c[0, 6] == 0 and c[0, 0] == 1  # the error's primary
    elif name == "uncounted_chunk":
        assert list(c[1, [0, 3, 4, 6]]) == [S.CHUNK // 2, -1, -1, 0]
        assert c[0, 6] == 3 and c[2, 6] == 1
    else:
        assert c[0, 1] == sum(1 for j in range(1300) if j % 9 == 4)
        # +0.0 terms alone, and terms that cancel: +0.0, never -0.0
        assert (kernels.runs[:2, 7:] == 0).all()
        assert kernels.runs[:2, 0].tolist() == [0, 1]


def _bytes_read_by_hand(data, start, end):
    """bam_scan.bytes_read's count for a well-formed stream under the
    default flag filter, walked record by record in Python: the bytes
    marked read, then the 32-byte sectors that hold one."""
    read = np.zeros(data.size, bool)

    def u(p, n):
        return int.from_bytes(data[p:p + n].tobytes(), "little")
    sizes = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4}
    pos = start
    while pos + 4 <= end and pos + 4 + u(pos, 4) <= end:
        rec, bs = pos + 4, u(pos, 4)
        read[pos:rec + 20] = True
        flag = u(rec + 14, 2)
        if not flag & (SKIP | 4):
            cig = rec + 32 + int(data[rec + 8])
            n_cig, l_seq = u(rec + 12, 2), u(rec + 16, 4)
            read[cig:cig + 4 * n_cig] = True
            a = cig + 4 * n_cig + (l_seq + 1) // 2 + l_seq
            while a + 3 <= rec + bs:
                tag, typ = data[a:a + 2].tobytes(), chr(data[a + 2])
                read[a:a + 3] = True
                a += 3
                if typ in sizes:
                    read[a:a + sizes[typ]] = True
                    a += sizes[typ]
                    if tag == b"NM":
                        break
                elif typ == "f":
                    a += 4
                elif typ in "ZH":
                    z = a + int(np.flatnonzero(data[a:] == 0)[0])
                    read[a:z + 1] = True
                    a = z + 1
                else:  # B
                    read[a:a + 5] = True
                    esz = {"c": 1, "C": 1, "s": 2, "S": 2}.get(
                        chr(data[a]), 4)
                    a += 5 + u(a + 1, 4) * esz
        pos = rec + bs
    return np.unique(np.flatnonzero(read) // S.SECTOR).size * S.SECTOR


@pytest.mark.parametrize("name", ["sorted", "forged", "long", "synth"])
def test_bytes_read_counts_the_sectors_the_scan_reads(bams, name):
    """The bound's byte count (chip_smoke.py's bam_scan bound_ms) equals a
    record-by-record walk's, and leaves out the names, sequences and
    qualities."""
    if name == "synth":
        data, start, n_ref = bams[name]
    else:
        data, start, n_ref = STREAMS[name](), 0, N_REF
    got = S.bytes_read(torch.from_numpy(data), start, data.size, n_ref,
                       SKIP, REQ)
    assert got == _bytes_read_by_hand(data, start, data.size)
    assert 0 < got < (data.size - start) * 3 // 4


@pytest.mark.parametrize("cut", [0, 1, 3, 37, 5000, 70000])
def test_every_end_equals_the_host_scan(host_kernels, cut):
    """The same stream ended short of its end: the carry starts where the
    host's does."""
    data = STREAMS["long"]()
    end = data.size - cut
    want = outcome_host(data, 0, end, N_REF)
    got, _, _ = scans(data, 0, end, N_REF, host_kernels)
    for out in got.values():
        assert_same(out, want)


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    """Inflated test BAMs: (bytes, records' start, n_ref)."""
    from coverm_tpu_torch.synth import write_sorted_bam
    d = tmp_path_factory.mktemp("bams")
    paths = {
        "scan_mixed": _tests_module("test_torch_scan").write_bam(
            str(d / "mixed.bam")),
        "scan_unsorted": _tests_module("test_torch_scan").write_bam(
            str(d / "unsorted.bam"), bad_sort=True),
        "scan_no_nm": _tests_module("test_torch_scan").write_bam(
            str(d / "no_nm.bam"), drop_nm=True),
        "filter_cases": _tests_module("test_torch_fused_filter").write_bam(
            str(d / "filter.bam")),
    }
    synth = str(d / "synth.bam")
    write_sorted_bam(synth, n_contigs=4, contig_len=300_000, seed=5)
    paths["synth"] = synth
    out = {}
    for name, path in paths.items():
        mm = np.fromfile(path, np.uint8)
        off, csz, usz = native.bgzf_scan(mm)
        data = native.bgzf_inflate_blocks(mm, off, csz, usz)
        header, start = _parse_header(data)
        out[name] = (data, start, header.n_ref)
    return out


BAM_NAMES = ["scan_mixed", "scan_unsorted", "scan_no_nm", "filter_cases",
             "synth"]


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("name", BAM_NAMES)
def test_bams_equal_the_host_scan(bams, host_kernels, name, filtered):
    data, start, n_ref = bams[name]
    rf = _tests_module("test_torch_fused_filter").METABAT[0] \
        if filtered else None
    for end in (data.size, (data.size + start) // 2):
        want = outcome_host(data, start, end, n_ref, rf)
        got, _, _ = scans(data, start, end, n_ref, host_kernels, rf)
        for out in got.values():
            assert_same(out, want)
    if name == "synth":
        assert want["n_records"] > 2 * S.CHUNK  # runs restart a chunk


def test_reference_bams_equal_the_host_scan(host_kernels):
    """CoverM's own test BAMs (htslib-written), where they are mounted:
    the kernels' host build and the plain version against the port's
    and the JAX package's host scans, unfiltered and under metabat's
    filter."""
    import glob
    from conftest import REFERENCE_DATA
    from coverm_tpu.io import native as jnative
    paths = sorted(glob.glob(os.path.join(REFERENCE_DATA, "*.bam")))
    if not paths:
        pytest.skip("reference test data not mounted")
    _tests_module("test_torch_native_build").load_jax_native()
    for path in paths:
        mm = np.fromfile(path, np.uint8)
        off, csz, usz = native.bgzf_scan(mm)
        data = native.bgzf_inflate_blocks(mm, off, csz, usz)
        header, start = _parse_header(data)
        for rf in (None, _metabat_filter()):
            want = outcome_host(data, start, data.size, header.n_ref, rf)
            if rf is None:
                assert_same(outcome_host(data, start, data.size,
                                         header.n_ref, mod=jnative), want)
            got, _, _ = scans(data, start, data.size, header.n_ref,
                              host_kernels, rf)
            for out in got.values():
                assert_same(out, want)


@pytest.mark.parametrize("name", BAM_NAMES + sorted(STREAMS))
def test_plain_version_equals_the_jax_package(bams, jax_native_loaded,
                                              name):
    """The plain version against the JAX package's host scan
    (coverm_tpu.io.native.stats_scan) on the same bytes."""
    from coverm_tpu.io import native as jnative
    if name in STREAMS:
        data = STREAMS[name]()
        start, n_ref = 0, N_REF
    else:
        data, start, n_ref = bams[name]
    want = outcome_host(data, start, data.size, n_ref, mod=jnative)
    sc = S.scan_segment(torch.from_numpy(data), start, data.size, n_ref,
                        SKIP, REQ)
    assert_same(outcome_scan(sc, n_ref), want)


@pytest.fixture(scope="module")
def jax_native_loaded():
    _tests_module("test_torch_native_build").load_jax_native()


def test_wrapper_checks_its_input():
    with pytest.raises(ValueError, match="uint8"):
        S.scan_segment(torch.zeros(8, dtype=torch.int32), 0, 8, 1, 0, 0)
    with pytest.raises(ValueError, match="within"):
        S.scan_segment(torch.zeros(8, dtype=torch.uint8), 0, 9, 1, 0, 0)
    empty = S.scan_segment(torch.zeros(3, dtype=torch.uint8), 0, 3, 1, 0, 0)
    assert empty.n_records == 0 and empty.end_off == 0
    assert empty.btid.size == 0 and empty.runs.shape == (0, S.RUN_WORDS)


# ---- the whole card route, the card stood in for by the CPU

@pytest.mark.parametrize("metabat", [False, True])
def test_contig_through_the_card_route_prints_the_jax_tsv(
        tmp_path, monkeypatch, jax_native_loaded, metabat):
    """`contig -b` with the card route on the CPU (SegmentInflater's slots
    and the scan's tensors on the CPU, so the scan is the plain version)
    prints what the JAX package's CLI prints; the host's stats_scan and
    ct_ingest_scan are never called."""
    from coverm_tpu import cli as jcli
    from coverm_tpu_torch import cli
    from coverm_tpu_torch.io import fastscan
    from coverm_tpu_torch.ops import bgzf_inflate as B
    # the filter's BAM holds a record out of order that only the filter
    # drops
    bam = (_tests_module("test_torch_fused_filter") if metabat else
           _tests_module("test_torch_scan")).write_bam(
               str(tmp_path / "s.bam"))
    methods = ["metabat"] if metabat else ["mean", "trimmed_mean",
                                           "variance", "covered_fraction"]
    argv = ["contig", "-b", bam, "-m", *methods]
    monkeypatch.setenv("COVERM_TPU_SEGMENT_BYTES", "8192")
    from coverm_tpu import modes as jmodes
    from coverm_tpu_torch import modes
    monkeypatch.setattr(jmodes, "STREAM_THRESHOLD_BYTES", 1)
    monkeypatch.setattr(modes, "STREAM_THRESHOLD_BYTES", 1)
    jax_out = str(tmp_path / "jax.tsv")
    assert jcli.main(argv + ["-o", jax_out]) in (0, None)
    made, scanned = [], []

    def inflater(dev):
        def make(path, off, csz, usz, segments, at):
            inf = B.SegmentInflater(path, off, csz, usz, segments, at,
                                    "cpu")
            made.append(inf)
            return inf
        return make

    def refused(*a, **k):
        raise AssertionError("the card route reached the host scan")
    orig = S.scan_segment

    def counted(*a, **k):
        scanned.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(fastscan, "_card_inflater", inflater)
    monkeypatch.setattr(native, "stats_scan", refused)
    monkeypatch.setattr(native, "ingest_scan", refused)
    monkeypatch.setattr(S, "scan_segment", counted)
    port_out = str(tmp_path / "port.tsv")
    assert cli.main(argv + ["-o", port_out], device="cpu") == 0
    with open(jax_out, "rb") as a, open(port_out, "rb") as b:
        assert b.read() == a.read()
    assert made and len(scanned) >= len(made[0].segments) > 4


# ---- on the card

@pytest.mark.cuda
def test_cuda_kernels_equal_plain_and_host(tmp_path):
    """The kernels on the card against the plain version and the host
    scan, on every stream and on a bench-shaped BAM segment by segment,
    and one launch counted a scan."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from coverm_tpu_torch.synth import write_sorted_bam
    dev = torch.device("cuda")
    for name, targets in FORGED.items():  # the stitch's check on the card
        data = STREAMS[name]()
        sc = S.scan_segment(torch.from_numpy(data).to(dev), 0, data.size,
                            N_REF, SKIP, REQ)
        assert sc.stitch[6] == targets[0]
        assert sc.regions_walked == len(targets)
    cases = [(STREAMS[name](), 0, N_REF) for name in sorted(STREAMS)]
    bam = str(tmp_path / "bench.bam")
    write_sorted_bam(bam, n_contigs=4, contig_len=300_000)
    mm = np.fromfile(bam, np.uint8)
    off, csz, usz = native.bgzf_scan(mm)
    data = native.bgzf_inflate_blocks(mm, off, csz, usz)
    header, start = _parse_header(data)
    cases.append((data, start, header.n_ref))
    for data, start, n_ref in cases:
        for rf in (None, _metabat_filter()):
            want = outcome_host(data, start, data.size, n_ref, rf)
            before = S.bam_scan_launches
            on_card = torch.from_numpy(data).to(dev)
            sc = S.scan_segment(on_card, start, data.size, n_ref, SKIP,
                                REQ, rf, timing=True)
            assert S.bam_scan_launches == before + 1
            plain = S.bam_scan_reference(torch.from_numpy(data), start,
                                         data.size, n_ref, SKIP, REQ, rf)
            assert_same(outcome_scan(sc, n_ref), want)
            assert_same(outcome_scan(plain, n_ref), want)
            np.testing.assert_array_equal(sc.stitch[:4], plain.stitch[:4])
            np.testing.assert_array_equal(sc.runs, plain.runs)
            np.testing.assert_array_equal(sc.chunks, plain.chunks)
            assert set(sc.timing) == {*S.STEPS, "block_scan", "d2h"}
            np.testing.assert_array_equal(
                sc.tail, data[sc.end_off:data.size])


def _metabat_filter():
    from coverm_tpu_torch.readfilter import FilterParams
    return FilterParams(min_percent_identity_single=0.97001)
