"""The record scan's speculate and records steps (coverm_tpu_torch/csrc/
bam_scan.cu steps (a) and (c), ops/bam_scan.py) on the CPU, through the
kernels' host build (bam_scan_host: a warp's lanes and a block's threads
one after another, the same functions as on the card).

The speculate: a lane a sub-range (SUB) of each 64 KiB region finds its
first plausible header and walks its chain to the sub-range's end, and
one lane joins the chains in order. Its four outputs (each region's first
start, where its chain left the region or stopped, its count of starts
and the starts) must equal the plain version's (ops/bam_scan._speculate,
a walk of each region from its first plausible header), for the scan's
min_bs of 33 and the parse's of 32, on every stream of
tests/test_torch_bam_scan.py and tests/test_torch_bam_parse.py and on
streams written for the join's edges: headers forged 2 bytes into
sub-ranges, records longer than a sub-range and than a region, chains
that stop mid-region (block_size 0, under min_bs, past the end) with
plausible chains in later lanes, a region whose first sub-ranges hold no
header, a last region shorter than a sub-range, records that start on
every sub-range's first byte and true records that fail the plausibility
test. Each edge stream is checked to reach its edge (a model of the lanes
in numpy), and the whole scan and parse on it to equal the host's and
the JAX package's.

The records step: a block a region, a thread a record; the analyse's last
block scans the regions' block counts. Its region bases and total must
be the exclusive scan of the plain version's counts, grouped by region,
and the blocks, runs and chunk words the host scan's, on streams of
regions of more than 256 records, regions with no counted record, and
regions the stitch walks.

On the card (`python -m pytest --noconftest -m cuda
tests/test_torch_bam_speculate.py tests/test_torch_bam_scan.py`) the
speculate's kernel gives the plain version's four arrays on every stream
and phase-4-shaped bytes, and the whole scan and parse the plain
versions' and the host's on the join's streams.
"""

import ctypes
import importlib
import struct

import numpy as np
import pytest
import torch

from coverm_tpu_torch.ops import bam_scan as S

from test_torch_bam_scan import (FORGED, N_REF, REQ, SKIP, _join,
                                 assert_same, forged_at_bytes, outcome_host,
                                 outcome_scan, record, small, sorted_stream)
from test_torch_bam_scan import STREAMS as SCAN_STREAMS
from test_torch_bam_scan import host_kernels  # noqa: F401


def _tests_module(name):
    return importlib.import_module(name)


# ---- streams for the join's edges

LANES = S.REGION // S.SUB  # sub-ranges a region


def forged_in_sub_ranges():
    """Headers forged 2 bytes into every sub-range of region 1 and every
    other one of region 2: each of those lanes' chains starts on a false
    header and stops, so the join walks the lane again from the true
    entry."""
    bounds = [S.REGION + k * S.SUB for k in range(LANES)]
    bounds += [2 * S.REGION + k * S.SUB for k in range(1, LANES, 2)]
    return forged_at_bytes(bounds, 4 * S.REGION)


def longer_than_a_sub_range():
    """Short records with one of 2 x SUB bases (three sub-ranges and
    more, under a region) every 40th."""
    out = []
    for j in range(2400):
        ln = 2 * S.SUB if j % 40 == 17 else 100
        out.append(record(j * N_REF // 2400, j, 0, ((0, ln),), ln,
                          nm=j % 4, name=b"s%d" % j))
    return out


def stop_mid_region(kind):
    """Records over several regions, the chain stopped in the middle of
    region 2 by `kind`, and plausible records in the later lanes and
    regions."""
    head = sorted_stream(260, 21, sizes=(100, 150))
    size = sum(map(len, head))
    while size < 2 * S.REGION + 20000:
        head.append(small(3, len(head)))
        size += len(head[-1])
    stop = {"zero": struct.pack("<I", 0) + bytes(60),
            "under_min_bs": struct.pack("<I", 20) + bytes(20),
            "past_the_end": struct.pack("<I", 0x7FFFFFF0) + bytes(60)}[kind]
    return head + [stop] + sorted_stream(300, 22, sizes=(100, 150))


def no_header_in_first_sub_ranges():
    """A record of 2 x SUB bases from 100 bytes before region 1: its
    first two sub-ranges hold no plausible header (a sequence of zero
    bytes and qualities of 0x1e)."""
    out, size = [], 0
    while size < S.REGION - 100 - 200:
        out.append(small(1, len(out)))
        size += len(out[-1])
    pad = S.REGION - 100 - size - 61  # a Z tag on one short record
    out.append(record(1, len(out), cigar=((0, 10),), l_seq=10, name=b"s",
                      aux=b"XZZ" + b"a" * (pad - 4) + b"\0"))
    out.append(record(2, 0, 0, ((0, 2 * S.SUB),), 2 * S.SUB, name=b"long"))
    return out + [small(3, j) for j in range(1500)]


def short_last_region():
    """Short records whose last region is 971 bytes, under one
    sub-range."""
    return [small(j * N_REF // 3239, j) for j in range(3239)]


def on_sub_range_bounds():
    """Records of 1,024 bytes each: one starts on each sub-range's first
    byte, so each lane's chain leaves its sub-range exactly at the next
    one's start."""
    out = []
    for j in range(400):
        r = record(j * N_REF // 400, j, 0, ((0, 100),), 100, name=b"b",
                   aux=b"XZZ\0")
        pad = 1024 - len(r)
        out.append(record(j * N_REF // 400, j, 0, ((0, 100),), 100,
                          name=b"b", aux=b"XZZ" + b"a" * pad + b"\0"))
    return out


def implausible_true_records():
    """Every seventh record with a tid out of range: a true record that
    the plausibility test refuses, often the first of a sub-range, so
    that the lane's chain starts after the join's entry."""
    return [record(N_REF if j % 7 == 3 else j * N_REF // 2000, j, 0,
                   ((0, 120),), 120, nm=j % 3, name=b"t%d" % j)
            for j in range(2000)]


JOIN_STREAMS = {
    "forged_in_sub_ranges": lambda: _join(forged_in_sub_ranges()),
    "longer_than_a_sub_range": lambda: _join(longer_than_a_sub_range()),
    "longer_than_a_region": SCAN_STREAMS["long"],
    "stops_at_zero_mid_region": lambda: _join(stop_mid_region("zero")),
    "stops_under_min_bs_mid_region": lambda: _join(
        stop_mid_region("under_min_bs")),
    "stops_past_the_end_mid_region": lambda: _join(
        stop_mid_region("past_the_end")),
    "no_header_in_first_sub_ranges": lambda: _join(
        no_header_in_first_sub_ranges()),
    "short_last_region": lambda: _join(short_last_region()),
    "on_sub_range_bounds": lambda: _join(on_sub_range_bounds()),
    "implausible_true_records": lambda: _join(implausible_true_records()),
}


def _all_streams():
    parse = _tests_module("test_torch_bam_parse").STREAMS
    out = {"scan_" + k: v for k, v in SCAN_STREAMS.items()}
    out.update({"parse_" + k: v for k, v in parse.items()
                if not k.startswith("scan_")})
    out.update({"join_" + k: v for k, v in JOIN_STREAMS.items()
                if all(v is not w for w in SCAN_STREAMS.values())})
    return out


ALL_STREAMS = sorted(_all_streams())


# ---- the speculate

@pytest.mark.parametrize("min_bs", [S.SCAN_MIN_BS, S.PARSE_MIN_BS])
@pytest.mark.parametrize("name", ALL_STREAMS)
def test_speculate_equals_the_plain_version(host_kernels, name, min_bs):
    data = torch.from_numpy(_all_streams()[name]())
    got = S.speculate(data, 0, data.numel(), N_REF, min_bs, host_kernels)
    want = S.speculate_reference(data, 0, data.numel(), N_REF, min_bs)
    for g, w, what in zip(got[:3], want[:3], ("first", "exit_", "cnt")):
        np.testing.assert_array_equal(g, w, err_msg=what)
    assert len(got[3]) == len(want[3])
    for b, (g, w) in enumerate(zip(got[3], want[3])):
        np.testing.assert_array_equal(g, w, err_msg=f"region {b}")
    assert got[0][0] == 0 and (got[0] >= -1).all()


def test_speculate_takes_the_card_or_the_plain_version():
    """Without a launch, a CPU tensor goes through the plain version."""
    data = torch.from_numpy(SCAN_STREAMS["sorted"]())
    got = S.speculate(data, 0, data.numel(), N_REF, S.SCAN_MIN_BS)
    want = S.speculate_reference(data, 0, data.numel(), N_REF,
                                 S.SCAN_MIN_BS)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[2].sum() == sum(x.size for x in got[3]) > 0


def lanes(data, n_ref=N_REF):
    """A model of the lanes: (each sub-range's first plausible header or
    -1, by region and lane; the true chain's starts)."""
    d = torch.from_numpy(data)
    end = data.size
    ok = S._plausible(d, torch.arange(end), end, n_ref).numpy()
    n_sub = -(-end // S.SUB)
    per = np.full(n_sub, -1, np.int64)
    hits = np.flatnonzero(ok)
    sub = hits // S.SUB
    first = np.unique(sub, return_index=True)
    per[first[0]] = hits[first[1]]
    per = np.append(per, np.full(-n_sub % LANES, -1))
    off, _ = S._chain(d, 0, end, n_ref)
    return per.reshape(-1, LANES), off


@pytest.mark.parametrize("name", sorted(JOIN_STREAMS))
def test_join_streams_reach_their_edges(name):
    data = JOIN_STREAMS[name]()
    per, off = lanes(data)
    true = set(off.tolist())
    sizes = np.diff(np.append(off, data.size))
    if name == "forged_in_sub_ranges":
        forged = [p for p in per[1:3].ravel() if p >= 0 and p not in true]
        assert len(forged) == LANES + LANES // 2
    elif name == "longer_than_a_sub_range":
        assert (sizes > 3 * S.SUB).sum() >= 20
        assert (sizes < S.REGION).all()
    elif name == "longer_than_a_region":
        assert (sizes > 2 * S.REGION).any()
    elif name.startswith("stops_"):
        words = S._chain(torch.from_numpy(data), 0, data.size, N_REF)[1]
        kind = {"stops_at_zero_mid_region": S.STOP_ZERO,
                "stops_under_min_bs_mid_region": S.STOP_TOO_SHORT,
                "stops_past_the_end_mid_region": S.STOP_PAST_END}[name]
        end_off = int(words[1])
        assert words[3] == kind and end_off // S.REGION == 2
        lane = end_off % S.REGION // S.SUB
        assert lane < LANES - 1 and (per[2, lane + 1:] >= 0).all()
        assert (per[3:] >= 0).any()
    elif name == "no_header_in_first_sub_ranges":
        assert (per[1, :2] == -1).all() and (per[1, 2:] >= 0).any()
    elif name == "short_last_region":
        assert 0 < data.size % S.REGION < S.SUB
    elif name == "on_sub_range_bounds":
        assert (off % 1024 == 0).all() and off.size == 400
    else:
        assert sum(1 for p in per.ravel() if p >= 0 and p not in true) == 0
        firsts = [int(x) for x in off if x % S.SUB < 300]
        refused = S._plausible(torch.from_numpy(data),
                               torch.tensor(firsts), data.size,
                               N_REF).numpy()
        assert (~refused).sum() >= 5


@pytest.fixture(scope="module")
def jax_native_loaded():
    _tests_module("test_torch_native_build").load_jax_native()


@pytest.mark.parametrize("name", sorted(JOIN_STREAMS))
def test_join_streams_scan_equal_the_host_scan(host_kernels,
                                               jax_native_loaded, name):
    """The whole scan on the join's streams (the kernels' host build and
    the plain version) against the port's and the JAX package's host
    scans."""
    from coverm_tpu.io import native as jnative
    data = JOIN_STREAMS[name]()
    want = outcome_host(data, 0, data.size, N_REF)
    assert_same(outcome_host(data, 0, data.size, N_REF, mod=jnative), want)
    t = torch.from_numpy(data)
    kernels = S.run_steps(t, 0, data.size, N_REF, SKIP, REQ, None,
                          host_kernels)
    plain = S.scan_segment(t, 0, data.size, N_REF, SKIP, REQ)
    assert_same(outcome_scan(kernels, N_REF), want)
    assert_same(outcome_scan(plain, N_REF), want)
    np.testing.assert_array_equal(kernels.stitch[:4], plain.stitch[:4])


@pytest.mark.parametrize("name", sorted(JOIN_STREAMS))
def test_join_streams_parse_equal_the_host_parse(host_kernels,
                                                 jax_native_loaded, name):
    """The whole parse on the join's streams against the port's and the
    JAX package's host parse."""
    from coverm_tpu.io import bam as jbam
    P = _tests_module("test_torch_bam_parse")
    data = JOIN_STREAMS[name]()
    want = P.outcome_host(data, 0, data.size)
    P.assert_same(P.outcome_host(data, 0, data.size, jbam), want)
    for out in P.parses(data, 0, data.size, N_REF, host_kernels).values():
        P.assert_same(out, want)


# ---- the records step

def _read(ptr, n, ctype):
    return np.ctypeslib.as_array((ctype * max(n, 1)).from_address(ptr))[
        :n].copy()


RECORD_STREAMS = ["sorted", "every_record_a_run", "uncounted_chunk",
                  *sorted(FORGED)]


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("name", RECORD_STREAMS)
def test_records_region_bases_are_the_scan_of_nblk(host_kernels,
                                                   jax_native_loaded, name,
                                                   filtered):
    """The analyse's region sums, region bases and total (read after its
    launch) against the plain version's per-record block counts summed by
    region and scanned; the outputs against the host scans."""
    from coverm_tpu.io import native as jnative
    rf = _tests_module("test_torch_fused_filter").METABAT[0] \
        if filtered else None
    data = SCAN_STREAMS[name]()
    seen = {}

    def launch(step, args):
        host_kernels(step, args)
        if step == 3:  # analyse
            n = args.n_regions
            seen.update(
                rblk=_read(args.rblk, n, ctypes.c_longlong),
                rbase=_read(args.rbase, n, ctypes.c_longlong),
                total=_read(args.pwords, 1, ctypes.c_longlong)[0],
                count=_read(args.count, n, ctypes.c_int),
                rank=_read(args.rank, n, ctypes.c_int))
    t = torch.from_numpy(data)
    kernels = S.run_steps(t, 0, data.size, N_REF, SKIP, REQ, rf, launch)
    off, _ = S._chain(t, 0, data.size, N_REF)
    nb = S._analyse(t, torch.from_numpy(off), N_REF, SKIP, REQ, rf)[2]
    region = off // S.REGION
    n_regions = -(-data.size // S.REGION)
    sums = np.bincount(region, weights=nb.numpy(),
                       minlength=n_regions).astype(np.int64)
    np.testing.assert_array_equal(seen["rblk"], sums)
    np.testing.assert_array_equal(seen["rbase"], np.cumsum(sums) - sums)
    assert seen["total"] == sums.sum() == kernels.btid.size
    want = outcome_host(data, 0, data.size, N_REF, rf)
    if rf is None:
        assert_same(outcome_host(data, 0, data.size, N_REF, mod=jnative),
                    want)
    assert_same(outcome_scan(kernels, N_REF), want)
    plain = S.scan_segment(t, 0, data.size, N_REF, SKIP, REQ, rf)
    np.testing.assert_array_equal(kernels.runs, plain.runs)
    np.testing.assert_array_equal(kernels.chunks, plain.chunks)
    counts = seen["count"]
    if name == "every_record_a_run":
        assert counts.max() > 4 * 256  # several tiles of a block
    elif name == "uncounted_chunk":
        assert ((counts > 0) & (sums == 0)).sum() >= 10
    elif name in FORGED:
        assert (seen["rank"][counts > 0] < 0).sum() == len(FORGED[name])


# ---- on the card

@pytest.mark.cuda
def test_cuda_speculate_and_join_streams_equal_the_plain_version():
    """The speculate's kernel against its plain version on every stream
    above at both min_bs, and the whole scan and parse on the join's
    streams against the plain versions and the host's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    P = _tests_module("test_torch_bam_parse")
    dev = torch.device("cuda")
    streams = _all_streams()
    for name in ALL_STREAMS:
        data = streams[name]()
        on_card = torch.from_numpy(data).to(dev)
        for min_bs in (S.SCAN_MIN_BS, S.PARSE_MIN_BS):
            got = S.speculate(on_card, 0, data.size, N_REF, min_bs)
            want = S.speculate_reference(torch.from_numpy(data), 0,
                                         data.size, N_REF, min_bs)
            for g, w in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(g, w, err_msg=name)
            for g, w in zip(got[3], want[3]):
                np.testing.assert_array_equal(g, w, err_msg=name)
    for name in sorted(JOIN_STREAMS):
        data = JOIN_STREAMS[name]()
        on_card = torch.from_numpy(data).to(dev)
        t = torch.from_numpy(data)
        want = outcome_host(data, 0, data.size, N_REF)
        sc = S.scan_segment(on_card, 0, data.size, N_REF, SKIP, REQ)
        plain = S.bam_scan_reference(t, 0, data.size, N_REF, SKIP, REQ)
        assert_same(outcome_scan(sc, N_REF), want)
        assert_same(outcome_scan(plain, N_REF), want)
        np.testing.assert_array_equal(sc.runs, plain.runs)
        np.testing.assert_array_equal(sc.chunks, plain.chunks)
        want = P.outcome_host(data, 0, data.size)
        P.assert_same(P.outcome_parse(lambda: S.parse_segment(
            on_card, 0, data.size, N_REF)), want)
        P.assert_same(P.outcome_parse(lambda: S.bam_parse_reference(
            t, 0, data.size, N_REF)), want)
