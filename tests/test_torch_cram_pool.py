"""The CRAM direct-stats route's slice pool (io/fastscan._cram_slice_blocks)
against the JAX package's one-thread scan, on the CPU.

The container walk hands each slice to a pool of threads (the block
inflate, CRC checks, rANS decode and ct_cram_stats_slice) and takes the
results in file order. At pool widths 1, 2, 4 and 8:

- parity: every slice's blocks and seg_counts, and every StatsAccum field
  (the float64 identity sums bit for bit), equal the JAX package's
  _cram_slice_blocks over each fixture of tests/test_torch_cram.py and a
  CRAM of 125 slices;
- error order: with slice k and a later slice corrupt, the error is the
  JAX package's, that of slice k, even when the later slice's worker
  fails first;
- early exits (an unsorted CRAM, a record without NM, a consumer that
  stops, a KeyboardInterrupt): no pool thread outlives the scan, every
  native handle decoded is freed, and the stream's CRAM plan is closed;
- the window: no more than 2 x width slices are ever in flight.
"""

import threading
import time

import numpy as np
import pytest

from coverm_tpu.flags import FlagFilter as JFlagFilter
from coverm_tpu.io import native as jnative
from coverm_tpu.io.fastscan import FusedScanStream as JFused
from coverm_tpu.io.fastscan import _cram_slice_blocks as j_slices
from coverm_tpu.io.fastscan import scan_sample_fused as j_scan_fused
from coverm_tpu.ops.depth import ReferenceLayout as JLayout
from coverm_tpu_torch.flags import FlagFilter
from coverm_tpu_torch.io import cram as C
from coverm_tpu_torch.io import fastscan as F
from coverm_tpu_torch.io import native
from coverm_tpu_torch.ops.depth import ReferenceLayout
from coverm_tpu_torch.scan import BamSortingError, MissingNMTagError

from test_torch_cram import EE, FIXTURES, TRIM, needs_native, sam_lines, \
    write
from test_torch_native_build import jax_native  # noqa: F401

WIDTHS = (1, 2, 4, 8)
CASES = {**FIXTURES, "many_slices": lambda: C.sam_to_cram_bytes(
    iter(sam_lines(2000, paired=True, seed=7)), records_per_slice=16)}
ACC_FIELDS = ("reads_primary", "reads_nonsupp", "reads_all", "nm_sum",
              "indel_sum", "ident_primary", "ident_nonsupp", "observed",
              "n_primary", "nm_missing", "n_records", "last_tid", "sorted")


@pytest.fixture
def width(request, monkeypatch):
    monkeypatch.setattr(F, "cram_workers", lambda: request.param)
    return request.param


def pool_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("cram-slice")]


def port_slices(path, ff):
    """[(btid, bstart, bend, seg_counts)] and the StatsAccum of the port's
    pool over the CRAM at `path`."""
    s = F.FusedScanStream(path)
    h = s.open()
    assert s._cram is not None
    stats = native.StatsAccum(h.n_ref)
    got = list(F._cram_slice_blocks(s, stats, *ff.masks()))
    assert s._cram is None
    return got, stats


def jax_slices(path, ff):
    js = JFused(path)
    jh = js.open()
    stats = jnative.StatsAccum(jh.n_ref)
    try:
        return list(j_slices(js, stats, *ff.masks())), stats
    finally:
        mm, _off, f = js._cram
        mm.close()
        f.close()


def jax_error(path):
    js = JFused(path)
    jh = js.open()
    with pytest.raises(Exception) as e:
        j_scan_fused(jh, js, JLayout.build(jh.target_lens, EE),
                     JFlagFilter(), False, trim=TRIM)
    return type(e.value).__name__, str(e.value)


def port_error(path):
    s = F.FusedScanStream(path)
    h = s.open()
    with pytest.raises(Exception) as e:
        F.scan_sample_fused(h, s, ReferenceLayout.build(h.target_lens, EE),
                            FlagFilter(), False, trim=TRIM, device="cpu")
    assert s._cram is None
    assert not pool_threads()
    return type(e.value).__name__, str(e.value)


@needs_native
@pytest.mark.parametrize("width", WIDTHS, indirect=True)
@pytest.mark.parametrize("case", list(CASES))
def test_pool_equals_the_jax_scan(tmp_path, case, width):
    path = write(tmp_path, CASES[case]())
    kw = {"include_improper_pairs": False} if case == "mixed_flags" else {}
    got, acc = port_slices(path, FlagFilter(**kw))
    want, jacc = jax_slices(path, JFlagFilter(**kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) == 4
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for f in ACC_FIELDS:
        a, b = np.asarray(getattr(acc, f)), np.asarray(getattr(jacc, f))
        assert a.dtype == b.dtype, f
        # bit for bit: the float64 sums add in the sequential order
        assert a.tobytes() == b.tobytes(), f
    assert acc.n_records > 0 and not pool_threads()


@needs_native
@pytest.mark.parametrize("width", (16,), indirect=True)
def test_pool_equals_the_jax_scan_under_thread_switch_stress(tmp_path,
                                                             width):
    """16 pool threads, more than cram_workers() ever starts, and the
    interpreter switching threads every 10 us: the in-order finish still
    adds every slice once, in order, bit for bit."""
    import sys
    path = write(tmp_path, CASES["many_slices"]())
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got, acc = port_slices(path, FlagFilter())
    finally:
        sys.setswitchinterval(interval)
    want, jacc = jax_slices(path, JFlagFilter())
    assert len(got) == len(want) > 100
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for f in ACC_FIELDS:
        assert (np.asarray(getattr(acc, f)).tobytes()
                == np.asarray(getattr(jacc, f)).tobytes()), f


def _spans(raw):
    """The walk's SliceTasks over the CRAM bytes `raw`."""
    _text, p = C.read_cram_header_text(raw)
    return list(C.walk_cram_slices(raw, p, lazy_skippable=True))


def corrupt(raw, task, kind):
    """`raw` with slice `task` broken as `kind` says: "crc" a lazy
    block's stored CRC, "gzip" a gzip block's body, "rans" a rANS
    block's body, "truncate" the file cut inside the slice's last block."""
    buf = bytearray(raw)
    if kind == "truncate":
        q0, hi = task.blocks[-1][3], task.blocks[-1][5]
        return bytes(buf[:(q0 + hi) // 2])
    method = {"crc": None, "gzip": C.M_GZIP, "rans": C.M_RANS}[kind]
    for m, _ct, _cid, _q0, lo, hi, _rs, lazy in task.blocks:
        if kind == "crc" and lazy and int.from_bytes(raw[hi:hi + 4],
                                                     "little"):
            buf[hi] ^= 0xFF
            return bytes(buf)
        if m == method and not lazy and hi - lo > 12:
            for j in range(lo + 4, hi - 4):
                buf[j] ^= 0x5A
            return bytes(buf)
    raise AssertionError(f"slice {task.index} has no block for {kind}")


ERROR_PAIRS = [("crc", "gzip"), ("gzip", "crc"), ("rans", "crc"),
               ("crc", "truncate"), ("gzip", "truncate")]


@needs_native
@pytest.mark.parametrize("width", (1, 2, 8), indirect=True)
@pytest.mark.parametrize("first,later", ERROR_PAIRS)
def test_error_of_the_first_bad_slice(tmp_path, monkeypatch, first, later,
                                      width):
    """Slice 2 and slice 9 are corrupt; slice 2's worker is held back, so
    the later slice fails first in time, but slice 2's error is raised."""
    raw = C.sam_to_cram_bytes(iter(sam_lines(400, seed=3)),
                              records_per_slice=24)
    tasks = _spans(raw)
    assert len(tasks) > 12
    both = corrupt(corrupt(raw, tasks[9], later), tasks[2], first)
    only_later = write(tmp_path, corrupt(raw, tasks[9], later), "later.cram")
    path = write(tmp_path, both, "both.cram")
    want = jax_error(path)
    assert want != jax_error(only_later)  # the two errors differ

    decode = F._decode_cram_slice

    def slow_first(raw, task, *args):
        if task.index == 2:
            time.sleep(0.2)
        return decode(raw, task, *args)

    monkeypatch.setattr(F, "_decode_cram_slice", slow_first)
    assert port_error(path) == want


@pytest.fixture
def handles(monkeypatch):
    """The native handles decoded and those freed, by address."""
    made, freed = [], []
    decode, lib = native.cram_stats_decode, native.get_lib()
    free = lib.ct_stats_free

    def counting_decode(*args, **kwargs):
        dec = decode(*args, **kwargs)
        if dec is not None:
            made.append(dec[0])
        return dec

    def counting_free(h):
        freed.append(h)
        return free(h)

    monkeypatch.setattr(native, "cram_stats_decode", counting_decode)
    monkeypatch.setattr(lib, "ct_stats_free", counting_free)
    return made, freed


def _two_contigs(unsorted=False, no_nm_at=None):
    """300 records, 16 a slice: 150 on c1 then 150 on c0 when
    `unsorted`, else c0 then c1; record `no_nm_at` without its NM tag."""
    sam = ["@SQ\tSN:c0\tLN:50000", "@SQ\tSN:c1\tLN:50000"]
    order = ("c1", "c0") if unsorted else ("c0", "c1")
    for j in range(300):
        nm = "" if j == no_nm_at else "\tNM:i:1"
        sam.append(f"r{j}\t0\t{order[j // 150]}\t{100 + 50 * (j % 150)}\t60"
                   f"\t40M\t*\t0\t0\t{'A' * 40}\t*{nm}")
    return C.sam_to_cram_bytes(iter(sam), records_per_slice=16)


EXITS = ("unsorted", "no_nm", "consumer_stops", "keyboard_interrupt")


@needs_native
@pytest.mark.parametrize("width", (2, 8), indirect=True)
@pytest.mark.parametrize("exit_by", EXITS)
def test_early_exit_joins_the_pool_and_frees_every_handle(
        tmp_path, handles, exit_by, width):
    raw = _two_contigs(unsorted=exit_by == "unsorted",
                       no_nm_at=200 if exit_by == "no_nm" else None)
    path = write(tmp_path, raw)
    before = set(threading.enumerate())
    s = F.FusedScanStream(path)
    h = s.open()
    layout = ReferenceLayout.build(h.target_lens, EE)
    ff = FlagFilter()
    dispatched = []

    def interrupt(layout, bt, *args, **kwargs):
        dispatched.append(bt.size)
        raise KeyboardInterrupt

    if exit_by == "consumer_stops":
        gen = F._cram_slice_blocks(s, native.StatsAccum(h.n_ref),
                                   *ff.masks())
        next(gen)
        gen.close()
    else:
        want = {"unsorted": BamSortingError, "no_nm": MissingNMTagError,
                "keyboard_interrupt": KeyboardInterrupt}[exit_by]
        with pytest.raises(want):
            F.scan_sample_fused(
                h, s, layout, ff, False, trim=TRIM, device="cpu",
                depth_fn=interrupt if exit_by == "keyboard_interrupt"
                else None)
    made, freed = handles
    assert made, "no slice was decoded"
    assert sorted(freed) == sorted(made)
    assert s._cram is None
    assert not pool_threads()
    assert set(threading.enumerate()) <= before
    if exit_by == "keyboard_interrupt":
        assert dispatched == [150]  # c0 closed; c1's slices not all read


@needs_native
@pytest.mark.parametrize("width", (2, 4, 8), indirect=True)
def test_no_more_than_two_slices_a_worker_in_flight(tmp_path, monkeypatch,
                                                    width):
    """Counted at each decode's start: the decodes started less the
    slices handed on. The consumer waits after each slice until every
    slice submitted has started, so the window fills."""
    path = write(tmp_path, CASES["many_slices"]())
    window = 2 * width
    lock = threading.Lock()
    count = {"started": 0, "received": 0, "max": 0}
    decode = native.cram_stats_decode

    def counting_decode(*args, **kwargs):
        with lock:
            count["started"] += 1
            count["max"] = max(count["max"],
                               count["started"] - count["received"])
        return decode(*args, **kwargs)

    monkeypatch.setattr(native, "cram_stats_decode", counting_decode)
    s = F.FusedScanStream(path)
    h = s.open()
    n = len(_spans(open(path, "rb").read()))
    for _ in F._cram_slice_blocks(s, native.StatsAccum(h.n_ref),
                                  *FlagFilter().masks()):
        with lock:
            count["received"] += 1
            j = count["received"] - 1
        deadline = time.monotonic() + 10
        while (count["started"] < min(j + window, n)
               and time.monotonic() < deadline):
            time.sleep(0.001)
    assert count["received"] == count["started"] == n > window
    assert window - 1 <= count["max"] <= window


@needs_native
@pytest.mark.parametrize("width", (1, 8), indirect=True)
def test_pool_workers_decode_rans_on_one_thread(tmp_path, monkeypatch,
                                                width):
    """Inside a pool worker rANS batches take one thread; the legacy
    route's direct call keeps rans_decode_batch's own count (0: the
    native default); both decode the same bytes."""
    path = write(tmp_path, CASES["many_slices"]())
    seen = []
    batch = native.rans_decode_batch

    def recording(blobs, sizes, n_threads=0):
        seen.append(n_threads)
        one = batch(blobs, sizes, n_threads=1)
        assert one == batch(blobs, sizes)
        return one

    monkeypatch.setattr(native, "rans_decode_batch", recording)
    port_slices(path, FlagFilter())
    assert seen and set(seen) == {1}
    seen.clear()
    raw = open(path, "rb").read()
    list(C.iter_cram_slice_blocks(raw, C.read_cram_header_text(raw)[1]))
    assert seen and set(seen) == {0}
