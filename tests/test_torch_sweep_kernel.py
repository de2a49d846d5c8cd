"""The port's sweep-scan kernel (coverm_tpu_torch/ops/sweep_scan.py)
against the JAX package's Pallas kernel in interpret mode, JAX's
`_sweep_core` and direct numpy models. Tolerance: exact integer equality.

The kernel takes the sorted int64 event keys and a length table; the
Pallas kernel takes six int32 arrays decoded from the same events. The
plain version (`sweep_scan_reference`) is what the wrapper runs for CPU
tensors; the CUDA kernel is compared with it on the card by the
`cuda`-marked cases, which skip without one. JAX is imported only by the
tests that run it, so that on a machine with a card and without JAX the
marked cases run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_sweep_kernel.py
"""

import numpy as np
import pytest
import torch

from coverm_tpu_torch.ops import sweep_scan as K

PAD_POS = K.PAD_POS
PAD_KEY = K.PAD_KEY
TILE = 2048  # the Pallas kernel's tile (16 x 128); E is padded to it


def build_sorted_events(lengths, tids, starts, ends):
    """Sorted event arrays in the layout the Pallas kernel consumes (a
    copy of the one in tests/test_pallas_sweep.py)."""
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


def build_keys(lengths, tids, starts, ends, E=None):
    """The kernel's inputs for the same events: sorted int64 keys as
    sweep.sort_events builds them (padded with PAD_KEY to E events when
    E is given) and the length table."""
    n_seg = len(lengths)
    keep = ends < lengths[tids]
    t = tids.astype(np.int64)
    key = np.sort(np.concatenate([
        np.arange(n_seg, dtype=np.int64) << 34,
        (t << 34) | ((starts.astype(np.int64) + 1) << 2) | 2,
        (t[keep] << 34) | ((ends[keep].astype(np.int64) + 1) << 2)]))
    if E is not None:
        key = np.concatenate([key, np.full(E - key.size, PAD_KEY)])
    len_tab = np.append(lengths, 0).astype(np.int32)
    return key, len_tab


def numpy_model(seg, pos, sign, paylen, next_seg, next_pos, ee):
    """Direct per-event model of the Pallas kernel's inputs (a copy of
    tests/test_pallas_sweep.py's): the forward fills as dictionaries.
    Returns (depth, w_len, full_len, length), all unmasked."""
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
    return depth, w_len, full_len, length


def numpy_per_seg(seg, depth, w_len, full_len, n_seg):
    """per_seg's six rows from unmasked per-event arrays, by np.add.at
    and np.maximum.at."""
    real = seg < n_seg
    s = seg[real]
    d = depth[real].astype(np.int64)
    w = w_len[real].astype(np.int64)
    cov = d > 0
    out = np.zeros((6, n_seg), np.int64)
    np.add.at(out[0], s, np.where(cov, d * w, 0))
    np.add.at(out[1], s, np.where(cov, w, 0))
    np.add.at(out[2], s, np.where(cov, full_len[real], 0))
    np.maximum.at(out[3], s, np.where(cov & (w > 0), d, 0))
    np.add.at(out[4], s, np.where(cov, d * d * w, 0))
    np.maximum.at(out[5], s, np.where(w > 0, K.BIGM - d, 0))
    return out


def segmented_scan(sign, is_sent):
    """The sign sum since the last sentinel at or before each event."""
    out = np.zeros(sign.size, np.int64)
    run = 0
    for i in range(sign.size):
        if is_sent[i]:
            run = 0
        run += int(sign[i])
        out[i] = run
    return out


def _random_blocks(rng, lengths, n_blocks, max_len=400, empty=()):
    """Sorted (tids, starts, ends), none on the contigs in `empty`."""
    pool = np.setdiff1d(np.arange(len(lengths)), np.asarray(empty, int))
    tids = np.sort(rng.choice(pool, n_blocks))
    starts = (rng.random(n_blocks) * (lengths[tids] - 1)).astype(np.int64)
    ends = np.minimum(starts + rng.integers(1, max_len, n_blocks),
                      lengths[tids])
    o = np.lexsort((starts, tids))
    return tids[o], starts[o], ends[o]


def _blocks(name):
    """(lengths, tids, starts, ends, ee) of one named case."""
    if name.startswith("seed"):  # the three cases of test_pallas_sweep.py
        seed, ee, n_blocks = {"seed0": (0, 0, 700), "seed1": (1, 75, 3000),
                              "seed2": (2, 10, 12000)}[name]
        rng = np.random.default_rng(seed)
        lengths = rng.integers(100, 9000, 13)
        tids = np.sort(rng.integers(0, 13, n_blocks))
        starts = (rng.random(n_blocks) * (lengths[tids] - 1)).astype(np.int64)
        ends = np.minimum(starts + rng.integers(1, 400, n_blocks),
                          lengths[tids])
        return lengths, tids, starts, ends, ee
    rng = np.random.default_rng(17)
    if name == "straddle":  # many small contigs: tiles cut through them
        lengths = rng.integers(150, 2500, 400)
        return (lengths, *_random_blocks(rng, lengths, 4000), 20)
    if name == "empty_contigs":  # contigs with no blocks, incl. first/last
        lengths = rng.integers(500, 6000, 30)
        empty = [0, 3, 4, 5, 17, 29]
        return (lengths, *_random_blocks(rng, lengths, 3000, empty=empty), 75)
    if name == "short_contigs":  # len <= 2*ee: no window at all
        lengths = np.array([100, 150, 151, 40, 3000, 149, 152, 2000])
        return (lengths, *_random_blocks(rng, lengths, 2500, max_len=200), 75)
    if name == "one_tile":  # E is exactly one Pallas tile
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
        return lengths, t, s, e, 75
    if name == "ends_at_contig_end":  # end events dropped at the contig end
        lengths = rng.integers(300, 3000, 12)
        t, s, e = _random_blocks(rng, lengths, 3000)
        at_end = rng.random(t.size) < 0.3
        e = np.where(at_end, lengths[t], e)
        return lengths, t, s, e, 75
    if name == "long_contig":  # one contig over 70 kernel tiles
        lengths = np.array([2_000_000, 5000])
        n = 160_000
        s = np.sort(rng.integers(0, lengths[0] - 1, n))
        e = np.minimum(s + rng.integers(1, 300, n), lengths[0])
        return lengths, np.zeros(n, np.int64), s, e, 75
    if name == "many_segments":  # above the dense-remap threshold
        lengths = rng.integers(100, 2000, 70_000)
        empty = rng.choice(70_000, 50_000, replace=False)
        return (lengths, *_random_blocks(rng, lengths, 30_000, empty=empty),
                75)
    raise KeyError(name)


def _case(name):
    """(six int32 arrays, ee): the Pallas kernel's inputs."""
    lengths, t, s, e, ee = _blocks(name)
    return build_sorted_events(lengths, t, s, e), ee


def _keys(name, pad=True):
    """(keys, len_tab, n_seg, ee): the kernel's inputs, padded with
    PAD_KEY to the Pallas kernel's E, or ragged (pad=False: three
    padding keys past the events)."""
    lengths, t, s, e, ee = _blocks(name)
    n_seg = len(lengths)
    if pad:
        E = _case(name)[0][0].size
    else:
        E = n_seg + t.size + int((e < lengths[t]).sum()) + 3
    key, len_tab = build_keys(lengths, t, s, e, E)
    return key, len_tab, n_seg, ee


def _reference(key, len_tab, n_seg, ee):
    return [x.numpy() for x in K.sweep_scan_reference(
        torch.from_numpy(key), torch.from_numpy(len_tab), n_seg, ee)]


CASES = ["seed0", "seed1", "seed2", "straddle", "empty_contigs",
         "short_contigs", "one_tile", "ends_at_contig_end"]
LARGE_CASES = ["long_contig", "many_segments"]


@pytest.mark.parametrize("name", CASES)
def test_reference_matches_pallas_and_numpy(name):
    import jax

    from coverm_tpu.ops import pallas_sweep
    assert pallas_sweep.TILE == TILE and pallas_sweep.PAD_POS == PAD_POS
    ins, ee = _case(name)
    key, len_tab, n_seg, _ = _keys(name)
    # the keys decode to the Pallas kernel's inputs
    seg, pos, sign = [x.numpy() for x in K.decode_keys(
        torch.from_numpy(key), n_seg)]
    for got, want in zip((seg, pos, sign), ins[:3]):
        np.testing.assert_array_equal(got, want)

    depth, w_all, seg_out, _ = _reference(key, len_tab, n_seg, ee)
    pal = [np.asarray(jax.device_get(x))
           for x in pallas_sweep.pallas_sweep_scan(*ins, ee,
                                                   interpret=True)]
    real = ins[1] < PAD_POS
    covered = depth > 0
    np.testing.assert_array_equal(depth[real], pal[0][real])
    np.testing.assert_array_equal(np.where(covered, w_all, 0)[real],
                                  pal[1][real])
    np.testing.assert_array_equal(seg_out, ins[0])
    m_depth, m_w, _, _ = numpy_model(*ins, ee)
    np.testing.assert_array_equal(w_all, m_w)  # the unmasked w_len
    np.testing.assert_array_equal(depth[real], m_depth[real])


@pytest.mark.parametrize("name", CASES)
def test_per_seg_matches_pallas_and_jax(name):
    """per_seg against the boundary differences of the Pallas outputs'
    cumsums, the Pallas window-max fill at each segment's last event,
    and JAX `_sweep_core` on the same blocks."""
    import jax
    import jax.numpy as jnp

    import coverm_tpu.ops.sweep as J
    from coverm_tpu.ops import pallas_sweep
    ins, ee = _case(name)
    key, len_tab, n_seg, _ = _keys(name)
    per_seg = _reference(key, len_tab, n_seg, ee)[3]
    assert per_seg.shape == (6, n_seg) and per_seg.dtype == np.int64

    depth, w_cov, f_cov, max_seg, max_val = [
        np.asarray(jax.device_get(x)).astype(np.int64)
        for x in pallas_sweep.pallas_sweep_scan(*ins, ee, interpret=True)]
    bounds = np.searchsorted(ins[0], np.arange(n_seg + 1))
    hi = bounds[1:] - 1
    lo = bounds[:-1] - 1

    def seg_diff(x):
        cs = np.cumsum(x)
        return cs[hi] - np.where(bounds[:-1] > 0, cs[np.maximum(lo, 0)], 0)

    np.testing.assert_array_equal(per_seg[0], seg_diff(depth * w_cov))
    np.testing.assert_array_equal(per_seg[1], seg_diff(w_cov))
    np.testing.assert_array_equal(per_seg[2], seg_diff(f_cov))
    np.testing.assert_array_equal(
        per_seg[3], np.where(max_seg[hi] == np.arange(n_seg), max_val[hi], 0))
    np.testing.assert_array_equal(per_seg[4], seg_diff(depth * depth * w_cov))

    lengths, t, s, e, _ = _blocks(name)
    r = J._fused_sweep(jnp.asarray(t, jnp.int32), jnp.asarray(s, jnp.int32),
                       jnp.asarray(e, jnp.int32),
                       jnp.ones(t.size, bool), jnp.asarray(e < lengths[t]),
                       jnp.asarray(lengths, jnp.int64), n_seg=n_seg, ee=ee)
    sum_w, cov_w, cov_f, max_w, _, _, _, _, sq_w, min_w = [
        np.asarray(jax.device_get(x)) for x in r]
    minpay = per_seg[5]
    for got, want in ((per_seg[0], sum_w), (per_seg[1], cov_w),
                      (per_seg[2], cov_f), (per_seg[3], max_w),
                      (per_seg[4], sq_w),
                      (np.where(minpay > 0, K.BIGM - minpay, 0), min_w)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CASES)
def test_two_facts(name):
    """The facts the kernel rests on: the lexmax length fill equals
    len_tab[seg] everywhere, and the carry-fill depth equals the
    sign scan restarted at each sentinel on real events (the global
    sign sum at every sentinel is >= 0)."""
    ins, ee = _case(name)
    seg, pos, sign, paylen = ins[:4]
    key, len_tab, n_seg, _ = _keys(name)
    m_depth, _, _, length = numpy_model(*ins, ee)
    np.testing.assert_array_equal(length, len_tab[seg])
    is_sent = pos == -1
    assert (np.cumsum(sign)[is_sent] >= 0).all()
    real = pos < PAD_POS
    restarted = segmented_scan(sign, is_sent)
    np.testing.assert_array_equal(m_depth[real], restarted[real])
    np.testing.assert_array_equal(_reference(key, len_tab, n_seg, ee)[0],
                                  restarted)


# the 64-bit look-back descriptor of csrc/sweep_scan.cu
AGGREGATE, INCLUSIVE, STATUS = 1 << 62, 2 << 62, 3 << 62
HAS_SENTINEL = 1 << 32


def _value(d):
    v = d & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _window_ready(desc, end, window):
    for i in range(end - 1, max(-1, end - 1 - window), -1):
        if not desc[i]:
            return False
        if desc[i] & STATUS == INCLUSIVE:
            return True
    return True


def look_back_model(sign, is_sent, tile, window, rng):
    """The kernel's decoupled look-back, tile by tile: tiles take tickets
    in order, then every step advances one started tile chosen at
    random; a look-back window spins until it is published from the
    nearest predecessor up to its first inclusive descriptor, or in
    full. Returns the per-event depth."""
    E = sign.size
    n_tiles = -(-E // tile)
    desc = [0] * n_tiles
    depth = np.zeros(E, np.int64)
    local = []
    for t in range(n_tiles):  # the tile's own segmented scan
        sl = slice(t * tile, min(E, (t + 1) * tile))
        dl = segmented_scan(sign[sl], is_sent[sl])
        hits = np.flatnonzero(is_sent[sl])
        first = hits[0] if hits.size else dl.size
        local.append((dl, first, bool(hits.size), int(dl[-1])))
    state = {}  # started tile -> [step, window end, partial sum]
    started = done = 0
    while done < n_tiles:
        ready = [t for t, st in state.items() if st[0] != "look"
                 or _window_ready(desc, st[1], window)]
        if started < n_tiles:
            ready.append(None)
        t = ready[rng.integers(len(ready))]
        if t is None:  # a block takes the next ticket
            state[started] = ["publish", started, 0]
            started += 1
            continue
        st = state[t]
        dl, first, f, agg = local[t]
        if st[0] == "publish":
            known = f or t == 0
            desc[t] = ((INCLUSIVE if known else AGGREGATE)
                       | (HAS_SENTINEL if f else 0) | (agg & 0xFFFFFFFF))
            st[0] = "look" if t > 0 else "finish"
            continue
        if st[0] == "look":  # one window of up to `window` predecessors
            ids = range(st[1] - 1, max(-1, st[1] - 1 - window), -1)
            for i in ids:
                st[2] += _value(desc[i])
                if desc[i] & STATUS == INCLUSIVE:
                    st[0] = "finish"
                    break
            else:
                st[1] -= window
                if st[1] <= 0:
                    st[0] = "finish"
            continue
        prefix = st[2]
        if not (f or t == 0):
            desc[t] = INCLUSIVE | ((prefix + agg) & 0xFFFFFFFF)
        out = dl.copy()
        out[:first] += prefix
        depth[t * tile:t * tile + dl.size] = out
        del state[t]
        done += 1
    assert all(d & STATUS == INCLUSIVE for d in desc)
    return depth


@pytest.mark.parametrize("seed", range(6))
def test_look_back_protocol(seed):
    """Random tile sizes and windows, sentinel densities from none to
    dense, tiles advanced in random order: the look-back gives the
    segmented scan."""
    rng = np.random.default_rng(100 + seed)
    E = int(rng.integers(50, 3000))
    sign = rng.choice([-1, 1], E)
    is_sent = rng.random(E) < [0.0, 0.002, 0.01, 0.05, 0.3, 1e-3][seed]
    is_sent[0] = seed != 0  # seed 0: no sentinel at all
    sign[is_sent] = 0
    tile = int(rng.integers(1, 64))
    window = int(rng.choice([1, 2, 4, 32]))
    got = look_back_model(sign, is_sent, tile, window, rng)
    np.testing.assert_array_equal(got, segmented_scan(sign, is_sent))


@pytest.mark.parametrize("name", LARGE_CASES)
def test_reference_large_cases(name):
    """The plain version on one contig of over 300k events and on more
    than 65,536 segments, ragged E, against the numpy models."""
    key, len_tab, n_seg, ee = _keys(name, pad=False)
    depth, w_all, seg, per_seg = _reference(key, len_tab, n_seg, ee)
    ins, _ = _case(name)
    m_depth, m_w, m_full, _ = numpy_model(*ins, ee)
    n = int((ins[1] < PAD_POS).sum())  # real events; padding after them
    assert n > 300_000 or n_seg > 65_536
    np.testing.assert_array_equal(depth[:n], m_depth[:n])
    np.testing.assert_array_equal(w_all[:n], m_w[:n])
    np.testing.assert_array_equal(seg[:n], ins[0][:n])
    assert not w_all[n:].any() and (seg[n:] == n_seg).all()
    np.testing.assert_array_equal(
        per_seg, numpy_per_seg(ins[0], m_depth, m_w, m_full, n_seg))


def test_wrapper_takes_plain_version_on_cpu():
    key, len_tab, n_seg, ee = _keys("seed1")
    t = torch.from_numpy(key), torch.from_numpy(len_tab)
    before = K.sweep_scan_launches
    got = K.sweep_scan(*t, n_seg, ee)
    want = K.sweep_scan_reference(*t, n_seg, ee)
    assert K.sweep_scan_launches == before  # no kernel launch on the CPU
    assert [g.dtype for g in got] == [torch.int32] * 3 + [torch.int64]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_rejects_bad_inputs():
    key, len_tab, n_seg, ee = _keys("seed0")
    k, lt = torch.from_numpy(key), torch.from_numpy(len_tab)
    with pytest.raises(ValueError):
        K.sweep_scan(k.int(), lt, n_seg, ee)
    with pytest.raises(ValueError):
        K.sweep_scan(k, lt[:-1], n_seg, ee)
    with pytest.raises(ValueError):
        K.sweep_scan(k, lt.long(), n_seg, ee)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES + LARGE_CASES)
def test_cuda_kernel_matches_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    key, len_tab, n_seg, ee = _keys(name, pad=name in CASES)
    dev = [torch.from_numpy(a).cuda() for a in (key, len_tab)]
    before = K.sweep_scan_launches
    got = K.sweep_scan(*dev, n_seg, ee)
    want = K.sweep_scan_reference(*dev, n_seg, ee)
    torch.cuda.synchronize()
    assert K.sweep_scan_launches == before + 1
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), K.PER_SEG_ROWS if k == 3 else k


def _last_card():
    """The card the multi-device cases run on: the last one, which on a
    one-card machine is cuda:0 itself (the case then checks only that the
    launch names its card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.device_count() - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["seed2", "empty_contigs"])
def test_cuda_kernel_on_the_last_card(name):
    """K1 launches on the card that holds its tensors while cuda:0 stays
    the current device, and the packed vector's fetch waits on that
    card's stream."""
    from coverm_tpu_torch.ops.sweep import _HostCopy
    dev = _last_card()
    key, len_tab, n_seg, ee = _keys(name)
    ins = [torch.from_numpy(a).to(dev) for a in (key, len_tab)]
    with torch.cuda.device(0):
        got = K.sweep_scan(*ins, n_seg, ee)
    want = K.sweep_scan_reference(*ins, n_seg, ee)
    torch.cuda.synchronize(dev)
    for g, w in zip(got, want):
        assert g.device == dev
        assert torch.equal(g, w)
    with torch.cuda.device(0):
        fetched = _HostCopy(got[3]).numpy()
    np.testing.assert_array_equal(fetched, want[3].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["0", "auto"])
def test_cuda_cli_scans_on_the_card_it_names(tmp_path, monkeypatch, mesh):
    """`cli.main(argv, device=cuda:k)` launches every K1 on cuda:k, with
    the multi-device engines off (COVERM_TPU_MESH=0) and on (auto), which
    would otherwise take every card."""
    from coverm_tpu_torch.cli import main as cli_main
    from coverm_tpu_torch.ops import sweep as S
    from coverm_tpu_torch.synth import write_sorted_bam
    dev = _last_card()
    bam = str(tmp_path / "x.bam")
    write_sorted_bam(bam, n_contigs=4, contig_len=20_000, coverage=5)
    monkeypatch.setenv("COVERM_TPU_MESH", mesh)
    seen = []

    def recording(key_s, *rest):
        seen.append(key_s.device)
        return K.sweep_scan(key_s, *rest)
    monkeypatch.setattr(S, "sweep_scan", recording)  # the engine's name
    assert cli_main(["contig", "-b", bam, "-m", "mean", "-o",
                     str(tmp_path / "out.tsv")], device=dev) == 0
    assert seen and set(seen) == {dev}


@pytest.mark.cuda
def test_cuda_launch_count_under_threads():
    """Eight threads launching at once: the count loses no launch."""
    import sys
    import threading
    dev = _last_card()
    key, len_tab, n_seg, ee = _keys("seed0")
    ins = [torch.from_numpy(a).to(dev) for a in (key, len_tab)]
    K.sweep_scan(*ins, n_seg, ee)  # build and load once
    before = K.sweep_scan_launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [K.sweep_scan(*ins, n_seg, ee) for _ in range(25)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    torch.cuda.synchronize(dev)
    assert K.sweep_scan_launches == before + 8 * 25
