"""The port's position-sharded depth step (coverm_tpu_torch/parallel/
mesh.py) against the JAX package's (coverm_tpu/parallel/mesh.py) on its
8-device virtual CPU mesh, and against the numpy oracle, as
tests/test_parallel.py holds the JAX one. The port runs on a [2][4] grid
of logical `cpu` devices. Tolerance: none (integer statistics).
"""

import jax
import numpy as np
import pytest
import torch

# coverm_tpu.ops.depth turns on JAX's 64-bit mode, as in the JAX
# package's own tests of this step (tests/test_parallel.py imports it):
# without it the JAX step computes in int32
import coverm_tpu.ops.depth  # noqa: F401
from coverm_tpu.parallel import mesh as J
from coverm_tpu_torch.ops.depth import (ReferenceLayout,
                                        compute_depth_stats_numpy)
from coverm_tpu_torch.parallel import mesh as T

CPU8 = [torch.device("cpu")] * 8


def positions(lengths, ee, n_pos):
    """tests/test_parallel.py's padded layout: every contig padded to a
    multiple of 128 positions, cut into n_pos equal pieces."""
    padded = (lengths + 127) // 128 * 128
    bases = np.concatenate(([0], np.cumsum(padded)))[:-1]
    P_total = int(padded.sum())
    assert P_total % n_pos == 0
    pos_seg = np.repeat(np.arange(lengths.size, dtype=np.int32), padded)
    pos_in = np.arange(P_total) - bases[pos_seg]
    lens_of = lengths[pos_seg]
    valid = pos_in < lens_of
    window = valid & (lens_of > 2 * ee) & (pos_in >= ee) \
        & (pos_in <= lens_of - 1 - ee)
    return bases, P_total, pos_seg, window, valid


def samples(seed, lengths, bases, P_total, n_pos, n_blocks, S=2):
    """Scatter points routed to the position shards, and the oracle's
    statistics, for S samples."""
    rng = np.random.default_rng(seed)
    layout = ReferenceLayout.build(lengths, 10)
    all_idx, all_val, oracle = [], [], []
    for _ in range(S):
        tids = rng.integers(0, lengths.size, n_blocks)
        starts = (rng.random(n_blocks) * (lengths[tids] - 1)).astype(np.int64)
        ends = np.minimum(starts + rng.integers(1, 150, n_blocks),
                          lengths[tids])
        keep = ends < lengths[tids]
        idx = np.concatenate([bases[tids] + starts,
                              np.where(keep, bases[tids] + ends, P_total)])
        val = np.concatenate([np.ones(n_blocks, np.int32),
                              -np.ones(n_blocks, np.int32)])
        got = T.route_scatter_points(idx, val, P_total, n_pos,
                                     pad_to=2 * n_blocks)
        want = J.route_scatter_points(idx, val, P_total, n_pos,
                                      pad_to=2 * n_blocks)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        all_idx.append(got[0])
        all_val.append(got[1])
        oracle.append(compute_depth_stats_numpy(layout, tids, starts, ends))
    return np.stack(all_idx), np.stack(all_val), oracle


@pytest.mark.parametrize("seed,lengths", [
    (0, [1000, 2000, 700, 1500, 128, 999]),
    (1, [5000, 130, 4000, 260, 3000, 777, 100]),
])
def test_sharded_step_equals_jax_and_oracle(seed, lengths):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh of tests/conftest.py")
    lengths = np.asarray(lengths)
    n = lengths.size
    grid = T.make_mesh(8, dp=2, devices=CPU8)
    n_pos = len(grid[0])
    bases, P_total, pos_seg, window, valid = positions(lengths, 10, n_pos)
    idx, val, oracle = samples(seed, lengths, bases, P_total, n_pos, 500)
    # n_seg above the contig count: segments that own no position
    for n_seg in (n, n + 2):
        got = T.sharded_depth_step(idx, val, pos_seg, window, valid, n_seg,
                                   grid)
        want = jax.device_get(J.sharded_depth_step(
            idx, val, pos_seg, window, valid, n_seg, J.make_mesh(8, dp=2)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        sum_w, cov_w, cov_f, max_w = got
        for s in range(2):
            np.testing.assert_array_equal(sum_w[s, :n],
                                          oracle[s].sum_depth_window)
            np.testing.assert_array_equal(cov_w[s, :n],
                                          oracle[s].covered_window)
            np.testing.assert_array_equal(cov_f[s, :n],
                                          oracle[s].covered_full)
            np.testing.assert_array_equal(np.maximum(max_w[s, :n], 0),
                                          oracle[s].max_depth_window)


def test_one_row_equals_more_pieces():
    """The same sample over 1, 2 and 8 position pieces (one dp row)."""
    lengths = np.array([1000, 2000, 700, 1500, 128, 999])
    outs = []
    for n_pos in (1, 2, 8):
        bases, P_total, pos_seg, window, valid = positions(lengths, 10,
                                                           n_pos)
        idx, val, _ = samples(3, lengths, bases, P_total, n_pos, 400, S=1)
        outs.append(T.sharded_depth_step(idx, val, pos_seg, window, valid,
                                         lengths.size,
                                         T.make_mesh(devices=CPU8[:n_pos])))
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            np.testing.assert_array_equal(a, b)


def test_bad_inputs_raise():
    grid = T.make_mesh(devices=CPU8[:2])
    z = np.zeros((1, 4), np.int32)
    seg = np.zeros(8, np.int32)
    ok = np.ones(8, bool)
    with pytest.raises(ValueError):
        T.sharded_depth_step(z, z, seg + 5, ok, ok, 3, grid)
    with pytest.raises(ValueError):
        T.make_mesh(devices=CPU8[:3], dp=2)
    with pytest.raises(ValueError):
        T.route_scatter_points(np.arange(10), np.ones(10, np.int32), 16, 2,
                               pad_to=2)
