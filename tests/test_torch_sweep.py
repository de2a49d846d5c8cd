"""The port's torch sweep engine (coverm_tpu_torch/ops/sweep.py) against
the JAX package's engine and the numpy oracle, on the CPU.

The parity surface is the packed int64 vector
[sum_w | cov_w | cov_f | max_w | sq_w | min_w | gmax (| trim) (| hist)]:
on the same u8 upload buffer it must be array_equal to
`coverm_tpu.ops.sweep._sweep_packed_u8`'s. The host helpers that build
that buffer must give the same bytes in both packages. Every statistic
is an integer, so every comparison is exact.
"""

import numpy as np
import pytest

import coverm_tpu.ops.sweep as J
from coverm_tpu.ops.depth import ReferenceLayout as JLayout
from coverm_tpu.ops.depth import compute_depth_stats_numpy as j_numpy
import coverm_tpu_torch.ops.sweep as T
from coverm_tpu_torch.modes import _dense_hist
from coverm_tpu_torch.ops.depth import ReferenceLayout, \
    compute_depth_stats_numpy

N_BINS = T.SPEC_HIST_BINS
FIELDS = ("sum_depth_window", "covered_window", "covered_full",
          "max_depth_window", "sumsq_window", "min_depth_window",
          "trimmed_sum")


def _blocks(rng, lengths, n_blocks, len_mode):
    C = lengths.size
    tids = np.sort(rng.integers(0, C, n_blocks))
    starts = (rng.random(n_blocks) * (lengths[tids] - 1)).astype(np.int64)
    o = np.lexsort((starts, tids))
    tids, starts = tids[o], starts[o]
    if len_mode == "scalar":
        lens = np.full(n_blocks, 150)
    elif len_mode == "u16":
        lens = rng.integers(1, 400, n_blocks)
    else:
        lens = rng.integers(1, 70000, n_blocks)
    return tids, starts, np.minimum(starts + lens, lengths[tids])


def _buffers(mod, layout, tids, starts, ends, start_mode):
    """(buf, seg_len, n_seg, len_mode, B) through `mod`'s host helpers."""
    nb = tids.size
    tids, starts, ends, _, n_seg, seg_len, _, _, counts = \
        mod.prep_segments(layout, tids, starts, ends)
    len_mode, scalar_len, vals = mod.choose_payload(layout, tids, starts,
                                                    ends)
    B = mod._bucket_geo(nb)
    if start_mode == "abs":
        first = np.zeros(n_seg + 1, np.int32)
        col = np.zeros(B, np.int32)
        col[:nb] = starts
    else:
        d, first, mode = mod.encode_start_deltas(starts, counts, nb)
        assert mode in ("d8", "d16")
        if start_mode == "d16":
            d = d.astype(np.uint16)
        else:
            assert mode == "d8"
        col = np.zeros(B, d.dtype)
        col[:nb] = d
    counts_ext = np.append(counts, B - nb).astype(np.int32)
    pay = None
    if vals is not None:
        pay = np.zeros(B, vals.dtype)
        pay[:nb] = vals
    buf = mod._pack_u8(scalar_len, counts_ext, first, col, pay, B, n_seg,
                       start_mode, len_mode)
    return buf, seg_len, n_seg, len_mode, B


# (len_mode, start_mode, need_hist, trim): the 3 x 3 payload grid, then
# histogram and trimmed-mean combinations
GRID = ([(lm, sm, False, None) for lm in ("scalar", "u16", "ends")
         for sm in ("abs", "d16", "d8")]
        + [("u16", "abs", True, None), ("u16", "abs", False, (0.05, 0.95)),
           ("scalar", "d8", True, (0.1, 0.9))])


@pytest.mark.parametrize("len_mode,start_mode,need_hist,trim", GRID)
def test_packed_vector_matches_jax(len_mode, start_mode, need_hist, trim):
    rng = np.random.default_rng(sum(map(ord, len_mode + start_mode)))
    ee = 75
    if start_mode == "abs":
        C, nb = 13, 3000
    else:  # dense blocks on few contigs keep the start deltas small
        C, nb = 3, 20000
    if len_mode == "ends":
        lengths = rng.integers(70000, 100000, C)
    else:
        lengths = rng.integers(100, 9000, C)
    tids, starts, ends = _blocks(rng, lengths, nb, len_mode)

    jl = JLayout.build(lengths, ee)
    tl = ReferenceLayout.build(lengths, ee)
    want_buf, seg_len, n_seg, lm, B = _buffers(J, jl, tids, starts, ends,
                                               start_mode)
    got_buf, *_ = _buffers(T, tl, tids, starts, ends, start_mode)
    assert lm == len_mode
    np.testing.assert_array_equal(got_buf, want_buf)

    acc = rng.integers(0, 1000, J.packed_result_len(
        n_seg, need_hist, N_BINS, trim is not None)).astype(np.int64)
    want = np.asarray(J._sweep_packed_u8(
        want_buf, acc, seg_len, n_seg=n_seg, ee=ee, need_hist=need_hist,
        n_bins=N_BINS, len_mode=len_mode, trim=trim, start_mode=start_mode,
        B=B))
    got = T.sweep_packed_u8(want_buf, acc, seg_len, n_seg, ee, need_hist,
                            N_BINS, len_mode, trim, start_mode, B,
                            device="cpu").numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def _assert_stats_equal(got, want, hist=False):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is None and b is None, f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    if hist:
        a, b = _dense_hist(got), _dense_hist(want)
        W = max(a.shape[1], b.shape[1])
        pa = np.zeros((a.shape[0], W), np.int64)
        pb = np.zeros((b.shape[0], W), np.int64)
        pa[:, :a.shape[1]] = a
        pb[:, :b.shape[1]] = b
        np.testing.assert_array_equal(pa, pb, err_msg="hist")


def _engines(lengths, tids, starts, ends, ee, need_hist, trim):
    """(port, JAX engine, numpy oracle) DepthStats of one block set."""
    got = T.compute_depth_stats_sweep(
        ReferenceLayout.build(lengths, ee), tids, starts, ends,
        need_hist=need_hist, trim=trim, device="cpu")
    jax_out = J.compute_depth_stats_sweep(
        JLayout.build(lengths, ee), tids, starts, ends,
        need_hist=need_hist, trim=trim)
    oracle = compute_depth_stats_numpy(
        ReferenceLayout.build(lengths, ee), tids, starts, ends,
        need_hist=need_hist, trim=trim)
    return got, jax_out, oracle


def test_engine_matches_jax_and_oracle():
    rng = np.random.default_rng(5)
    lengths = rng.integers(100, 9000, 21)
    tids, starts, ends = _blocks(rng, lengths, 5000, "u16")
    got, jax_out, oracle = _engines(lengths, tids, starts, ends, 75, True,
                                    (0.05, 0.95))
    _assert_stats_equal(got, jax_out, hist=True)
    _assert_stats_equal(got, oracle, hist=True)


def test_oracle_copy_matches_jax_oracle():
    rng = np.random.default_rng(6)
    lengths = rng.integers(100, 3000, 9)
    tids, starts, ends = _blocks(rng, lengths, 800, "u16")
    got = compute_depth_stats_numpy(ReferenceLayout.build(lengths, 10),
                                    tids, starts, ends, need_hist=True,
                                    trim=(0.1, 0.9))
    want = j_numpy(JLayout.build(lengths, 10), tids, starts, ends,
                   need_hist=True, trim=(0.1, 0.9))
    _assert_stats_equal(got, want, hist=True)


def test_histogram_overflow_rows():
    """Contigs deeper than the speculative width (gmax >= 512) get exact
    ragged hist_wide rows; the others keep their dense rows."""
    rng = np.random.default_rng(8)
    lengths = np.array([3000, 400, 5000, 2500])
    t1, s1, e1 = _blocks(rng, lengths, 1500, "u16")
    deep = np.full(700, 1)  # 700 blocks stacked on contig 1
    ds = rng.integers(0, 50, 700)
    tids = np.concatenate([t1, deep])
    starts = np.concatenate([s1, ds])
    ends = np.concatenate([e1, np.minimum(ds + 300, 400)])
    o = np.lexsort((starts, tids))
    tids, starts, ends = tids[o], starts[o], ends[o]
    got, jax_out, oracle = _engines(lengths, tids, starts, ends, 75, True,
                                    None)
    assert got.max_depth_window[1] >= N_BINS
    assert set(got.hist_wide) == set(jax_out.hist_wide) == {1}
    np.testing.assert_array_equal(got.hist_wide[1], jax_out.hist_wide[1])
    _assert_stats_equal(got, jax_out, hist=True)
    _assert_stats_equal(got, oracle, hist=True)


def test_dense_remap_above_65536_contigs():
    rng = np.random.default_rng(9)
    C = T.DENSE_REMAP_THRESHOLD + 500
    lengths = rng.integers(200, 2000, C)
    hit = np.sort(rng.choice(C, 300, replace=False))
    tids = np.sort(rng.choice(hit, 3000))
    starts = (rng.random(tids.size) * (lengths[tids] - 1)).astype(np.int64)
    o = np.lexsort((starts, tids))
    tids, starts = tids[o], starts[o]
    ends = np.minimum(starts + rng.integers(1, 300, tids.size),
                      lengths[tids])
    got, jax_out, oracle = _engines(lengths, tids, starts, ends, 75, False,
                                    (0.05, 0.95))
    _assert_stats_equal(got, jax_out)
    _assert_stats_equal(got, oracle)


def test_accumulator_over_contig_disjoint_batches():
    """Several contig-closed batches folded on the device into one
    DepthAccumulator equal one sweep over all blocks."""
    rng = np.random.default_rng(10)
    lengths = rng.integers(500, 9000, 16)
    tids, starts, ends = _blocks(rng, lengths, 6000, "scalar")
    trim = (0.05, 0.95)
    layout = ReferenceLayout.build(lengths, 75)
    acc = T.DepthAccumulator()
    for lo, hi in ((0, 5), (5, 6), (6, 12), (12, 16)):
        sel = (tids >= lo) & (tids < hi)
        empty = T.compute_depth_stats_sweep(
            layout, tids[sel], starts[sel], ends[sel], trim=trim,
            deferred=True, acc=acc, device="cpu")
        assert not empty.result().sum_depth_window.any()
    acc.start_fetch()
    got = acc.result()
    oracle = compute_depth_stats_numpy(layout, tids, starts, ends, trim=trim)
    jax_out = J.compute_depth_stats_sweep(JLayout.build(lengths, 75), tids,
                                          starts, ends, trim=trim)
    _assert_stats_equal(got, oracle)
    _assert_stats_equal(got, jax_out)


def test_empty_input():
    layout = ReferenceLayout.build(np.array([100, 200]), 0)
    e = np.zeros(0, np.int64)
    got = T.compute_depth_stats_sweep(layout, e, e, e, need_hist=True,
                                      device="cpu")
    assert got.sum_depth_window.tolist() == [0, 0]
    assert got.hist.shape == (2, 1)
