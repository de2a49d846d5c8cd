"""The port's contig-sharded mesh sweep (coverm_tpu_torch/parallel/
mesh_sweep.py) against the JAX package's (coverm_tpu/parallel/
mesh_sweep.py) and the port's single-device engine.

The JAX side runs on the 8-device virtual CPU mesh that tests/conftest.py
sets up; the port side on eight logical `cpu` shards. The same inputs,
made from a seed with numpy, go to both. Tolerance: none — the routing
arrays are equal, every int64 statistic bit-equal, the histograms and
their ragged overflow rows equal.
"""

import jax
import numpy as np
import pytest
import torch

from coverm_tpu.ops.depth import ReferenceLayout as JLayout
from coverm_tpu.parallel import mesh_sweep as J
from coverm_tpu_torch.ops.depth import ReferenceLayout
from coverm_tpu_torch.ops.sweep import compute_depth_stats_sweep
from coverm_tpu_torch.parallel import mesh_sweep as T

CPU8 = [torch.device("cpu")] * 8
FIELDS = ["sum_depth_window", "covered_window", "covered_full",
          "max_depth_window", "sumsq_window", "min_depth_window",
          "trimmed_sum"]


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh of tests/conftest.py")
    return J.make_shard_mesh(8)


def workload(seed=42, n_contigs=23, nb=5000):
    """tests/test_mesh_sweep.py's workload."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(200, 5000, n_contigs).astype(np.int64)
    tids = np.sort(rng.integers(0, n_contigs, nb)).astype(np.int64)
    starts = (rng.random(nb) * (lengths[tids] - 1)).astype(np.int64)
    ends = np.minimum(starts + rng.integers(1, 300, nb), lengths[tids])
    return lengths, 75, (tids, starts, ends)


def heavy_blocks(seed=0):
    """tests/test_position_split.py's heavy contig: one contig with 8000
    blocks beside seven of 286, so the 8-shard route splits it."""
    rng = np.random.default_rng(seed)
    lengths = np.array([50_000, 3000, 3000, 3000, 3000, 3000, 3000, 3000])
    n = [8000] + [286] * 7
    ts, ss, es = [], [], []
    for c, k in enumerate(n):
        s = np.sort(rng.integers(0, lengths[c] - 120, k))
        ts.append(np.full(k, c))
        ss.append(s)
        es.append(s + rng.integers(80, 120, k))
    return lengths, 75, tuple(np.concatenate(x) for x in (ts, ss, es))


def deep_blocks():
    """tests/test_position_split.py's deep contig: split, and deep enough
    to overflow the speculative histogram (a ragged hist_wide row)."""
    rng = np.random.default_rng(9)
    lengths = np.array([1000, 2000, 700, 1500, 3000, 801])
    t = np.concatenate([np.zeros(6000, np.int64), np.full(200, 4, np.int64)])
    s = np.concatenate([np.sort(rng.integers(0, 940, 6000)),
                        np.sort(rng.integers(0, 2940, 200))])
    e = s + rng.integers(30, 60, t.size)
    return lengths, 10, (t, s, e)


def assert_stats_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)
    if a.hist is None or b.hist is None:
        assert a.hist is None and b.hist is None
    else:
        np.testing.assert_array_equal(a.hist, b.hist)
    wa, wb = a.hist_wide or {}, b.hist_wide or {}
    assert sorted(wa) == sorted(wb)
    for c in wa:
        np.testing.assert_array_equal(wa[c], wb[c])


def both(blocks_fn, need_hist, trim, jax_mesh, **kw):
    """(JAX mesh, port mesh, port single-device) DepthStats."""
    lengths, ee, blocks = blocks_fn()
    want = J.compute_depth_stats_sweep_mesh(
        JLayout.build(lengths, ee), *blocks, need_hist=need_hist, trim=trim,
        mesh=jax_mesh, **kw)
    layout = ReferenceLayout.build(lengths, ee)
    got = T.compute_depth_stats_sweep_mesh(
        layout, *blocks, need_hist=need_hist, trim=trim,
        mesh=T.make_shard_mesh(devices=CPU8), **kw)
    single = compute_depth_stats_sweep(layout, *blocks, need_hist=need_hist,
                                       trim=trim, device="cpu")
    return want, got, single


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_routing_equals_jax(seed):
    """assign_contigs, split_heavy_contigs, _route_sample and
    _pack_shards give JAX's arrays, with and without the split."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 500, 40)
    counts[rng.integers(40)] = 20_000
    for n in (1, 3, 8):
        np.testing.assert_array_equal(T.assign_contigs(counts, n),
                                      J.assign_contigs(counts, n))
    lengths, ee, blocks = heavy_blocks(seed) if seed % 2 else workload(seed)
    for n in (2, 8):
        for got, want in zip(T.split_heavy_contigs(*blocks, n),
                             J.split_heavy_contigs(*blocks, n)):
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
        for split in (False, True):
            got = T._route_sample(ReferenceLayout.build(lengths, ee),
                                  *blocks, n, allow_split=split)
            want = J._route_sample(JLayout.build(lengths, ee), *blocks, n,
                                   allow_split=split)
            assert len(got) == len(want)
            for k, (g, w) in enumerate(zip(got, want)):
                if w is None or np.isscalar(w) or isinstance(w, str):
                    assert g == w, k
                else:
                    np.testing.assert_array_equal(g, np.asarray(w),
                                                  err_msg=str(k))
            (_, st, vals, offs, cm, lm, _, n_seg, *_rest,
             per_shard, _) = got
            B_local = max(int(per_shard.max()), 1) + 5
            for g, w in zip(
                    T._pack_shards(st, vals, offs, cm, B_local, n, n_seg, lm),
                    J._pack_shards(st, vals, offs, cm, B_local, n, n_seg,
                                   lm)):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype


@pytest.mark.parametrize("need_hist,trim", [
    (False, None), (False, (0.05, 0.95)), (True, None), (True, (0.1, 0.9))])
def test_mesh_equals_jax_and_single_device(jax_mesh, need_hist, trim):
    want, got, single = both(workload, need_hist, trim, jax_mesh)
    assert_stats_equal(got, want)
    assert_stats_equal(got, single)


def test_empty_shards_and_empty_input(jax_mesh):
    """One contig over eight shards: seven shards sweep padding only."""
    want, got, single = both(lambda: workload(n_contigs=1, nb=50), False,
                             (0.05, 0.95), jax_mesh)
    assert_stats_equal(got, want)
    assert_stats_equal(got, single)
    lengths, ee, _ = workload(n_contigs=1, nb=50)
    empty = [np.empty(0, np.int64)] * 3
    e = T.compute_depth_stats_sweep_mesh(
        ReferenceLayout.build(lengths, ee), *empty,
        mesh=T.make_shard_mesh(devices=CPU8))
    assert (e.sum_depth_window == 0).all()
    pending = T.compute_depth_stats_sweep_mesh(
        ReferenceLayout.build(lengths, ee), *empty, deferred=True,
        mesh=T.make_shard_mesh(devices=CPU8))
    pending.start_fetch()
    assert (pending.result().covered_full == 0).all()


@pytest.mark.parametrize("need_hist,trim", [
    (False, (0.1, 0.9)), (True, None), (False, None), (True, (0.05, 0.95))])
def test_position_split_equals_jax_and_single_device(jax_mesh, need_hist,
                                                     trim):
    want, got, single = both(heavy_blocks, need_hist, trim, jax_mesh)
    assert_stats_equal(got, want)
    for f in FIELDS:  # the histogram's width may differ from the single
        x, y = getattr(got, f), getattr(single, f)
        assert (x is None and y is None) or np.array_equal(x, y), f
    if not need_hist:
        assert got.hist is None  # not requested: dropped after the fix


def test_deep_split_contig_ragged_hist(jax_mesh):
    """A split contig whose summed piece maxima overflow the speculative
    histogram: its row comes from the host oracle over the unsplit
    blocks, and min, max and trimmed are read from it."""
    want, got, single = both(deep_blocks, True, (0.05, 0.95), jax_mesh)
    assert_stats_equal(got, want)
    assert got.hist_wide and 0 in got.hist_wide
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(single, f),
                                      err_msg=f)


def test_deferred_equals_eager():
    lengths, ee, blocks = heavy_blocks()
    layout = ReferenceLayout.build(lengths, ee)
    mesh = T.make_shard_mesh(devices=CPU8)
    pending = T.compute_depth_stats_sweep_mesh(layout, *blocks, trim=(0.1, 0.9),
                                               mesh=mesh, deferred=True)
    pending.start_fetch()
    assert_stats_equal(pending.result(), T.compute_depth_stats_sweep_mesh(
        layout, *blocks, trim=(0.1, 0.9), mesh=mesh))


def test_dp2_rows_equal_jax_mesh_sweep():
    """Two samples stacked as the dp rows of one call over a [2][4] grid
    (scripts/dp_ab_bench.py's stacked form): the packed vectors equal
    JAX's `_mesh_sweep` over make_shard_mesh(8, dp=2)."""
    import jax.numpy as jnp
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh of tests/conftest.py")
    rng = np.random.default_rng(5)
    C, L, trim = 12, 20_000, (0.05, 0.95)
    lengths = np.full(C, L, np.int64)
    samples = []
    for _ in range(2):
        t = np.sort(rng.integers(0, C, 6000)).astype(np.int64)
        s = (rng.random(t.size) * (L - 1)).astype(np.int64)
        o = np.lexsort((s, t))
        samples.append((t[o], s[o], np.minimum(s[o] + 150, L)))
    n_shards = 4
    layout = ReferenceLayout.build(lengths, 75)
    routed = [T._route_sample(layout, *b, n_shards) for b in samples]
    B_local = T._bucket_geo(max(int(r[12].max()) for r in routed),
                            minimum=128)
    n_seg, seg_len, len_mode = routed[0][7], routed[0][8], routed[0][5]
    rows_s, rows_p, rows_c, sl = [], [], [], []
    for r in routed:
        assert r[5] == len_mode
        sp, pp, ce = T._pack_shards(r[1], r[2], r[3], r[4], B_local,
                                    n_shards, n_seg, r[5])
        rows_s.append(sp.reshape(-1))
        rows_p.append(pp.reshape(-1))
        rows_c.append(ce)
        sl.append([r[6]])
    args = (np.stack(rows_s), np.stack(rows_p), np.stack(rows_c), seg_len,
            np.asarray(sl, np.int32))
    for need_hist in (False, True):
        got = T.mesh_sweep(*args, n_seg, 75, need_hist, 512, len_mode, trim,
                           T.make_shard_mesh(dp=2, devices=CPU8))
        want = np.asarray(jax.device_get(J._mesh_sweep(
            *(jnp.asarray(a) for a in args), n_seg, 75, need_hist, 512,
            len_mode, trim, J.make_shard_mesh(8, dp=2))))
        assert len(got) == 2
        for s in range(2):
            np.testing.assert_array_equal(got[s].numpy(), want[s])


def test_grid_shapes():
    assert T.make_shard_mesh(devices=CPU8) == [CPU8]
    assert T.make_shard_mesh(4, dp=2, devices=CPU8) == [CPU8[:2], CPU8[2:4]]
    with pytest.raises(ValueError):
        T.make_shard_mesh(dp=3, devices=CPU8[:2])
    with pytest.raises(ValueError):  # 3 samples over 2 dp rows
        T.mesh_sweep(np.zeros((3, 8), np.int32), None, None, None, None, 1,
                     0, False, 1, "abs", None, [CPU8[:1], CPU8[:1]])
