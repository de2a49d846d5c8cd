"""Thread-DP over device groups against stacked dp rows of one
`mesh_sweep` call.

The CLI's multi-sample path scans samples on concurrent threads, each
contig-sharding over its own group of devices (modes._scanned, arm A).
The alternative stacks the S samples as dp rows of one
parallel/mesh_sweep.mesh_sweep call over an (S, n/S) grid (arm B). This
script runs both on S = 2 samples of B blocks (32 contigs x 1 Mbp,
150 bp reads, seed 0), asserts that the six int64 fields are bit-equal
between the arms, and times them.

The port's mesh_sweep issues its rows and shards one after the other
from one thread, where the JAX package's _mesh_sweep is one dispatch: so
arm B here asks whether one thread issuing every (row, shard) beats
threads issuing one group each, not whether one fused dispatch does.

Devices: every card when there are at least two; on one card, four
logical devices over cuda:0 (two groups of two shards), where the A/B
gives no verdict about cards; on the CPU, COVERM_TPU_TORCH_CPU_DEVICES
logical devices (8 when unset).

Run:  python -m coverm_tpu_torch.scripts.dp_ab_bench [--blocks 400000]
          [--reps 5] [--device cpu]
Ends with one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .common import add_device_arg, result_line

S = 2
TRIM = (0.05, 0.95)
FIELDS = ("sum_depth_window", "covered_window", "covered_full",
          "sumsq_window", "min_depth_window", "trimmed_sum")


def make_samples(B, C=32, L=1_000_000, RL=150):
    """The layout and S samples of B sorted blocks each, from seed 0."""
    from ..ops.depth import ReferenceLayout
    rng = np.random.default_rng(0)
    layout = ReferenceLayout.build(np.full(C, L, np.int64), 75)
    samples = []
    for _ in range(S):
        t = np.sort(rng.integers(0, C, B)).astype(np.int64)
        st = (rng.random(B) * (L - 1)).astype(np.int64)
        order = np.lexsort((st, t))
        t, st = t[order], st[order]
        samples.append((t, st, np.minimum(st + RL, L)))
    return layout, samples


def bench_devices(device):
    """(devices, one_card): every local device, or four logical ones over
    the card when there is only one."""
    from ..device import local_devices
    devs = local_devices(device)
    if device.type == "cuda" and len(devs) < 2:
        return [devs[0]] * 4, True
    return devs, False


def thread_dp(layout, samples, devs):
    """Arm A: sample i on its own thread over device group devs[i::S], as
    modes._scanned groups them."""
    from ..parallel.mesh_sweep import compute_depth_stats_sweep_mesh
    groups = [devs[i::S] for i in range(S)]

    def job(i):
        t, st, en = samples[i]
        g = groups[i]
        with (torch.cuda.device(g[0]) if g[0].type == "cuda"
              else contextlib.nullcontext()):
            return compute_depth_stats_sweep_mesh(
                layout, t, st, en, need_hist=False, trim=TRIM, mesh=[g])
    with ThreadPoolExecutor(max_workers=S) as ex:
        return list(ex.map(job, range(S)))


def stacked_dp(layout, samples, devs):
    """Arm B: the S samples as dp rows of one mesh_sweep call over an
    (S, n/S) grid, routed and packed as parallel/mesh_sweep.sweep_routed
    does for one."""
    from ..device import device_grid
    from ..ops.sweep import SPEC_HIST_BINS, _bucket_geo, unpack_packed
    from ..parallel.mesh_sweep import _pack_shards, _route_sample, mesh_sweep

    grid = device_grid(dp=S, devices=devs)
    n_shards = len(grid[0])
    routed = [_route_sample(layout, *samples[s], n_shards) for s in range(S)]
    B_local = _bucket_geo(max(int(r[12].max(initial=1)) for r in routed),
                          minimum=128)
    n_seg, seg_len, n_out = routed[0][7], routed[0][8], routed[0][9]
    len_mode = routed[0][5]
    rows_s, rows_p, rows_c, sl, row_tids = [], [], [], [], []
    for r in routed:
        (_seg, starts_sorted, vals_sorted, offsets, counts_mat, lm,
         scalar_len, _ns, _sd, _no, _obs, tids_s, _ps, _sp) = r
        if lm != len_mode:
            raise ValueError("the samples' block lengths take different "
                             "payload modes")
        sp, pp, ce = _pack_shards(starts_sorted, vals_sorted, offsets,
                                  counts_mat, B_local, n_shards, n_seg, lm)
        rows_s.append(sp.reshape(-1))
        rows_p.append(pp.reshape(-1))
        rows_c.append(ce)
        sl.append([scalar_len])
        row_tids.append(tids_s)
    packed = mesh_sweep(np.stack(rows_s), np.stack(rows_p), np.stack(rows_c),
                        seg_len, np.asarray(sl, dtype=np.int32), n_seg,
                        layout.contig_end_exclusion, False, SPEC_HIST_BINS,
                        len_mode, TRIM, grid)
    return [unpack_packed(layout, packed[s].cpu().numpy(), n_seg, n_out,
                          None, row_tids[s], False, TRIM, SPEC_HIST_BINS)
            for s in range(S)]


def run(B, reps, device, out=print):
    """Both arms, each one untimed call and then `reps` timed ones;
    raises unless they are bit-equal. Returns the record and the two
    arms' results."""
    from ..ops import sweep_scan as K
    devs, one_card = bench_devices(device)
    layout, samples = make_samples(B)
    out(f"{len(devs)} devices ({', '.join(str(d) for d in devs)})")

    def timeit(label, fn):
        r = fn()
        times, launches = [], K.sweep_scan_launches
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        best = min(times)
        out(f"{label}: times {[round(t, 4) for t in times]} "
            f"best={best:.4f}s ({S * B / best / 1e6:.2f}M blocks/s)")
        return best, times, r, (K.sweep_scan_launches - launches) // reps

    ta, times_a, ra, launches_a = timeit("thread-DP (device groups)",
                                         lambda: thread_dp(layout, samples,
                                                           devs))
    tb, times_b, rb, launches_b = timeit("stacked-dp (mesh_sweep rows)",
                                         lambda: stacked_dp(layout, samples,
                                                            devs))
    for s in range(S):
        for f in FIELDS:
            if not np.array_equal(getattr(ra[s], f), getattr(rb[s], f)):
                raise RuntimeError(f"the arms differ in sample {s}'s {f}")
    ratio = tb / ta
    verdict = "stacked wins" if tb < ta else "thread-DP wins"
    if one_card:
        verdict += "; one card, four logical devices: no verdict for cards"
    out(f"bit parity OK; stacked/thread wall ratio {ratio:.3f}x "
        f"({verdict})")
    return {"blocks_per_sample": B, "samples": S, "reps": reps,
            "devices": [str(d) for d in devs], "one_card": one_card,
            "thread_dp_best_s": ta, "thread_dp_times_s": times_a,
            "stacked_best_s": tb, "stacked_times_s": times_b,
            "stacked_over_thread": ratio, "verdict": verdict,
            "k1_launches_a_call": {"thread_dp": launches_a,
                                   "stacked": launches_b},
            "note": "the port's mesh_sweep issues rows and shards from one "
                    "thread, where JAX's is one dispatch"}, ra, rb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=400_000,
                    help="blocks a sample")
    ap.add_argument("--reps", type=int, default=5)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    from ..device import CPU_DEVICES_VAR, resolve_device
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        os.environ.setdefault(CPU_DEVICES_VAR, "8")
    res, _, _ = run(args.blocks, args.reps, dev)
    print(result_line(dev, tool="dp_ab_bench", **res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
