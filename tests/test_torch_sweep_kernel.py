"""The port's sweep-scan kernel (coverm_tpu_torch/ops/sweep_scan.py)
against the JAX package's Pallas kernel in interpret mode and a direct
numpy model. Tolerance: exact int32 equality.

The plain version (`sweep_scan_reference`) is what the wrapper runs for
CPU tensors; the CUDA kernel is compared with it on the card by the
`cuda`-marked cases, which skip without one. JAX is imported only by
the test that runs the Pallas kernel, so that on a machine with a card
and without JAX the marked cases run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_sweep_kernel.py
"""

import numpy as np
import pytest
import torch

from coverm_tpu_torch.ops import sweep_scan as K

PAD_POS = K.PAD_POS
TILE = 2048  # the Pallas kernel's tile (16 x 128); E is padded to it


def build_sorted_events(lengths, tids, starts, ends):
    """Sorted event arrays in the layout the kernel consumes (a copy of
    tests/test_pallas_sweep.py's builder)."""
    n_seg = len(lengths)
    keep = ends < lengths[tids]
    seg = np.concatenate([np.arange(n_seg), tids, tids[keep]]).astype(np.int64)
    pos = np.concatenate([np.full(n_seg, -1), starts, ends[keep]]).astype(np.int64)
    sign = np.concatenate([np.zeros(n_seg), np.ones(len(tids)),
                           -np.ones(int(keep.sum()))]).astype(np.int32)
    paylen = np.concatenate([lengths, np.zeros(len(tids) + int(keep.sum()))
                             ]).astype(np.int32)
    order = np.lexsort((sign, pos, seg))
    seg, pos, sign, paylen = seg[order], pos[order], sign[order], paylen[order]
    E = ((seg.size + TILE - 1) // TILE) * TILE
    pad = E - seg.size
    seg = np.concatenate([seg, np.full(pad, n_seg)]).astype(np.int32)
    pos = np.concatenate([pos, np.full(pad, PAD_POS)]).astype(np.int32)
    sign = np.concatenate([sign, np.zeros(pad, np.int32)])
    paylen = np.concatenate([paylen, np.zeros(pad, np.int32)])
    next_seg = np.concatenate([seg[1:], [n_seg]]).astype(np.int32)
    next_pos = np.concatenate([pos[1:], [PAD_POS]]).astype(np.int32)
    return seg, pos, sign, paylen, next_seg, next_pos


def numpy_model(seg, pos, sign, paylen, next_seg, next_pos, ee):
    """Direct per-event model (a copy of tests/test_pallas_sweep.py's),
    extended with the running per-contig window-max fill."""
    E = seg.size
    gsign = np.cumsum(sign)
    length = np.zeros(E, np.int64)
    carry = np.zeros(E, np.int64)
    cur_len = {}
    cur_carry = {}
    for i in range(E):
        if pos[i] == -1:
            cur_len[seg[i]] = paylen[i]
            cur_carry[seg[i]] = gsign[i]
        length[i] = cur_len.get(seg[i], 0)
        carry[i] = cur_carry.get(seg[i], 0)
    depth = gsign - carry
    gap_end = np.where(next_seg == seg, next_pos.astype(np.int64), length)
    full_len = np.clip(np.minimum(gap_end, length) - np.maximum(pos, 0), 0, None)
    w_len = np.clip(np.minimum(gap_end, length - ee) - np.maximum(pos, ee),
                    0, None)
    w_len = np.where(length > 2 * ee, w_len, 0)
    is_pad = pos >= PAD_POS
    full_len = np.where(is_pad, 0, full_len)
    w_len = np.where(is_pad, 0, w_len)
    covered = depth > 0
    cs_sum = np.cumsum(np.where(covered, depth.astype(np.int64) * w_len, 0))
    cs_cov = np.cumsum(np.where(covered, w_len, 0))
    cs_ful = np.cumsum(np.where(covered, full_len, 0))
    run_max = np.zeros(E, np.int64)
    cur_max = {}
    for i in range(E):
        if covered[i] and w_len[i] > 0:
            cur_max[seg[i]] = max(cur_max.get(seg[i], 0), int(depth[i]))
        run_max[i] = cur_max.get(seg[i], 0)
    return cs_sum, cs_cov, cs_ful, depth, w_len, full_len, run_max


def _random_blocks(rng, lengths, n_blocks, max_len=400, empty=()):
    """Sorted (tids, starts, ends), none on the contigs in `empty`."""
    pool = np.setdiff1d(np.arange(len(lengths)), np.asarray(empty, int))
    tids = np.sort(rng.choice(pool, n_blocks))
    starts = (rng.random(n_blocks) * (lengths[tids] - 1)).astype(np.int64)
    ends = np.minimum(starts + rng.integers(1, max_len, n_blocks),
                      lengths[tids])
    o = np.lexsort((starts, tids))
    return tids[o], starts[o], ends[o]


def _case(name):
    """(inputs, ee) of one named case."""
    if name.startswith("seed"):  # the three cases of test_pallas_sweep.py
        seed, ee, n_blocks = {"seed0": (0, 0, 700), "seed1": (1, 75, 3000),
                              "seed2": (2, 10, 12000)}[name]
        rng = np.random.default_rng(seed)
        lengths = rng.integers(100, 9000, 13)
        tids = np.sort(rng.integers(0, 13, n_blocks))
        starts = (rng.random(n_blocks) * (lengths[tids] - 1)).astype(np.int64)
        ends = np.minimum(starts + rng.integers(1, 400, n_blocks),
                          lengths[tids])
        return build_sorted_events(lengths, tids, starts, ends), ee
    rng = np.random.default_rng(17)
    if name == "straddle":  # many small contigs: tiles cut through them
        lengths = rng.integers(150, 2500, 400)
        return build_sorted_events(
            lengths, *_random_blocks(rng, lengths, 4000)), 20
    if name == "empty_contigs":  # contigs with no blocks, incl. first/last
        lengths = rng.integers(500, 6000, 30)
        empty = [0, 3, 4, 5, 17, 29]
        return build_sorted_events(
            lengths, *_random_blocks(rng, lengths, 3000, empty=empty)), 75
    if name == "short_contigs":  # len <= 2*ee: no window at all
        lengths = np.array([100, 150, 151, 40, 3000, 149, 152, 2000])
        return build_sorted_events(
            lengths, *_random_blocks(rng, lengths, 2500, max_len=200)), 75
    if name == "one_tile":  # E is exactly one tile
        # 3 sentinels + 1023 starts + 1022 ends: one block ends at its
        # contig's end and drops its end event
        lengths = np.array([700, 5000, 3000])
        n = 1023
        t = np.sort(rng.integers(0, 3, n))
        s = (rng.random(n) * (lengths[t] - 300)).astype(np.int64)
        e = s + rng.integers(1, 300, n)
        o = np.lexsort((s, t))
        t, s, e = t[o], s[o], e[o]
        e[-1] = lengths[t[-1]]
        ins = build_sorted_events(lengths, t, s, e)
        assert ins[0].size == TILE
        return ins, 75
    if name == "ends_at_contig_end":  # end events dropped at the contig end
        lengths = rng.integers(300, 3000, 12)
        t, s, e = _random_blocks(rng, lengths, 3000)
        at_end = rng.random(t.size) < 0.3
        e = np.where(at_end, lengths[t], e)
        return build_sorted_events(lengths, t, s, e), 75
    raise KeyError(name)


CASES = ["seed0", "seed1", "seed2", "straddle", "empty_contigs",
         "short_contigs", "one_tile", "ends_at_contig_end"]


@pytest.mark.parametrize("name", CASES)
def test_reference_matches_pallas_and_numpy(name):
    import jax

    from coverm_tpu.ops import pallas_sweep
    assert pallas_sweep.TILE == TILE and pallas_sweep.PAD_POS == PAD_POS
    ins, ee = _case(name)
    got = [t.numpy() for t in K.sweep_scan_reference(
        *[torch.from_numpy(a) for a in ins], ee)]
    pal = [np.asarray(jax.device_get(x))
           for x in pallas_sweep.pallas_sweep_scan(*ins, ee,
                                                   interpret=True)]
    for k, field in enumerate(("depth", "w_len", "full_len", "max_seg",
                               "max_val")):
        np.testing.assert_array_equal(got[k], pal[k], err_msg=field)
    cs_sum, cs_cov, cs_ful, depth, w_len, full_len, run_max = \
        numpy_model(*ins, ee)
    covered = depth > 0
    np.testing.assert_array_equal(got[0], depth)
    np.testing.assert_array_equal(got[1], np.where(covered, w_len, 0))
    np.testing.assert_array_equal(got[2], np.where(covered, full_len, 0))
    np.testing.assert_array_equal(got[5], w_len)  # the unmasked w_len
    real = ins[1] < PAD_POS
    np.testing.assert_array_equal(got[4][real], run_max[real])
    np.testing.assert_array_equal(got[3][real], ins[0][real])
    np.testing.assert_array_equal(
        np.cumsum(got[0].astype(np.int64) * got[1]), cs_sum)
    np.testing.assert_array_equal(np.cumsum(got[1], dtype=np.int64), cs_cov)
    np.testing.assert_array_equal(np.cumsum(got[2], dtype=np.int64), cs_ful)


def test_wrapper_takes_plain_version_on_cpu():
    ins, ee = _case("seed1")
    t = [torch.from_numpy(a) for a in ins]
    before = K.sweep_scan_launches
    got = K.sweep_scan(*t, ee)
    want = K.sweep_scan_reference(*t, ee)
    assert K.sweep_scan_launches == before  # no kernel launch on the CPU
    assert len(got) == K.N_OUT
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert torch.equal(g, w)


def test_wrapper_rejects_bad_inputs():
    ins, ee = _case("seed0")
    t = [torch.from_numpy(a) for a in ins]
    with pytest.raises(ValueError):
        K.sweep_scan(*t[:5], t[5].long(), ee)
    with pytest.raises(ValueError):
        K.sweep_scan(*t[:5], t[5][:-1], ee)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_matches_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    ins, ee = _case(name)
    dev = [torch.from_numpy(a).cuda() for a in ins]
    before = K.sweep_scan_launches
    got = K.sweep_scan(*dev, ee)
    want = K.sweep_scan_reference(*dev, ee)
    torch.cuda.synchronize()
    assert K.sweep_scan_launches == before + 1
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), k
