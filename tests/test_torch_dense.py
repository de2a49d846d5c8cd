"""The port's dense depth engine (coverm_tpu_torch/ops/depth.py:
ReferenceLayout's chunk packing, stats_core_math, hist_core,
compute_depth_stats) against the JAX package's ops/depth.py and the
numpy oracle, on the CPU.

Every statistic is an integer, so every comparison is exact: the
per-contig int64 fields, the trimmed-mean numerators and the histogram
(padded to a common width). The cases are tests/test_depth_engines.py's
(seeds 0-3 with end exclusions 0, 75, 10 and 600, and trims), the empty
sample, and layouts cut into many chunks; stats_core_math is held
against the JAX function on __graft_entry__.entry's inputs (P = 16384,
K = 64, 2048 scatter points, seed 0).
"""

import numpy as np
import pytest
import torch

import coverm_tpu.ops.depth as J
from coverm_tpu_torch.ops import depth as T

FIELDS = ("sum_depth_window", "covered_window", "covered_full",
          "max_depth_window", "sumsq_window", "min_depth_window",
          "trimmed_sum")


def _case(seed, n_contigs=12, n=800, max_len=5000):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(50, max_len, n_contigs)
    tids = rng.integers(0, n_contigs, n)
    starts = (rng.random(n) * (lengths[tids] - 1)).astype(np.int64)
    ends = np.minimum(starts + rng.integers(1, 300, n), lengths[tids])
    return lengths, tids, starts, ends


def _padded(h, W):
    out = np.zeros((h.shape[0], W), np.int64)
    out[:, :h.shape[1]] = h
    return out


def assert_stats_equal(got, want, label):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is None and b is None, (label, f)
        else:
            assert a.dtype == np.int64, (label, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{label} {f}")
    if got.hist is not None or want.hist is not None:
        W = max(got.hist.shape[1], want.hist.shape[1])
        np.testing.assert_array_equal(_padded(got.hist, W),
                                      _padded(want.hist, W),
                                      err_msg=f"{label} hist")


def _observed_hist_rows(stats, tids):
    """The oracle's histogram counts depth-0 positions only on observed
    contigs; the engines count them on every contig of a touched chunk."""
    keep = np.zeros(stats.hist.shape[0], bool)
    keep[np.unique(tids)] = True
    stats.hist = np.where(keep[:, None], stats.hist, 0)
    return stats


@pytest.mark.parametrize("trim", [None, (0.05, 0.95)])
@pytest.mark.parametrize("seed,ee", [(0, 0), (1, 75), (2, 10), (3, 600)])
def test_dense_engine_equals_jax_and_oracle(seed, ee, trim):
    lengths, tids, starts, ends = _case(seed)
    got = T.compute_depth_stats(T.ReferenceLayout.build(lengths, ee), tids,
                                starts, ends, need_hist=True, trim=trim,
                                device="cpu")
    want = J.compute_depth_stats(J.ReferenceLayout.build(lengths, ee), tids,
                                 starts, ends, need_hist=True, trim=trim)
    assert_stats_equal(got, want, "jax")
    oracle = T.compute_depth_stats_numpy(
        T.ReferenceLayout.build(lengths, ee), tids, starts, ends,
        need_hist=True, trim=trim)
    assert_stats_equal(_observed_hist_rows(got, tids), oracle, "oracle")


@pytest.mark.parametrize("chunk_positions", [1 << 10, 1 << 12])
@pytest.mark.parametrize("need_hist", [False, True])
def test_many_chunks_equal_jax(chunk_positions, need_hist):
    """Contigs packed into many chunks (some untouched), the chunk layout
    and the statistics equal the JAX package's."""
    lengths, tids, starts, ends = _case(4, n_contigs=40, n=1500,
                                        max_len=2000)
    tids[tids % 7 == 3] = 0  # leave some contigs, and chunks, empty
    layout = T.ReferenceLayout(lengths, 20, chunk_positions)
    jlayout = J.ReferenceLayout(lengths, 20, chunk_positions)
    assert (layout.P, layout.K) == (jlayout.P, jlayout.K)
    assert len(layout.chunks) == len(jlayout.chunks) > 4
    np.testing.assert_array_equal(layout.chunk_of_contig,
                                  jlayout.chunk_of_contig)
    np.testing.assert_array_equal(layout.base_of_contig,
                                  jlayout.base_of_contig)
    for ci in range(len(layout.chunks)):
        for a, b in zip(layout.device_chunk(ci, "cpu"),
                        jlayout.device_chunk(ci)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = T.compute_depth_stats(layout, tids, starts, ends,
                                need_hist=need_hist, trim=(0.1, 0.9),
                                device="cpu")
    want = J.compute_depth_stats(jlayout, tids, starts, ends,
                                 need_hist=need_hist, trim=(0.1, 0.9))
    assert_stats_equal(got, want, "jax")


@pytest.mark.parametrize("trim", [None, (0.05, 0.95)])
def test_empty_sample(trim):
    lengths = np.array([500, 600])
    empty = np.array([], int)
    got = T.compute_depth_stats(T.ReferenceLayout.build(lengths, 0), empty,
                                empty, empty, need_hist=True, trim=trim,
                                device="cpu")
    want = J.compute_depth_stats(J.ReferenceLayout.build(lengths, 0), empty,
                                 empty, empty, need_hist=True, trim=trim)
    assert_stats_equal(got, want, "empty")
    assert got.hist.shape == (2, 1) and not got.hist.any()


def test_stats_core_math_equals_jax_on_the_graft_entry_inputs():
    from __graft_entry__ import entry
    fn, args = entry()
    want = [np.asarray(x) for x in fn(*args)]
    idx, val, pos_seg, window, valid = (np.array(a) for a in args)
    got = T.stats_core_math(torch.from_numpy(idx), torch.from_numpy(val),
                            torch.from_numpy(pos_seg.astype(np.int64)),
                            torch.from_numpy(window),
                            torch.from_numpy(valid), 64)
    assert len(got) == len(want) == 7
    for k, (g, w) in enumerate(zip(got, want)):
        g = g.numpy()
        assert g.shape == w.shape, k
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=str(k))
    assert (want[4] != 0).any() and (want[4] < 0).any()


@pytest.mark.parametrize("n_bins", [128, 1024])
def test_hist_core_equals_jax(n_bins):
    lengths, tids, starts, ends = _case(2, n_contigs=6, n=3000)
    layout = T.ReferenceLayout.build(lengths, 10)
    jlayout = J.ReferenceLayout.build(lengths, 10)
    ch = layout.chunks[0]
    base = layout.base_of_contig[tids]
    keep = ends < lengths[tids]
    idx = np.concatenate([base + starts,
                          np.where(keep, base + ends, layout.P)])
    val = np.concatenate([np.ones(tids.size), -np.ones(tids.size)])
    pos_seg, window, valid = layout.device_chunk(0, "cpu")
    r = T.stats_core_math(torch.from_numpy(idx), torch.from_numpy(val),
                          pos_seg, window, valid, layout.K)
    got = T.hist_core(r[4], pos_seg, window, layout.K, n_bins).numpy()
    jpos, jwin, jval = jlayout.device_chunk(0)
    jr = J._stats_core(J.jnp.asarray(idx.astype(np.int32)),
                       J.jnp.asarray(val.astype(np.int32)), jpos, jwin,
                       jval, jlayout.K)
    want = np.asarray(J._hist_core(jr[4], jpos, jwin, jlayout.K, n_bins))
    np.testing.assert_array_equal(r[4].numpy(), np.asarray(jr[4]))
    np.testing.assert_array_equal(got, want)
    assert got[: ch.n_local].sum() > 0
