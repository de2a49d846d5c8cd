#!/usr/bin/env python3
"""Smoke run of coverm_tpu_torch (the PyTorch/CUDA port) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: the sweep-scan kernel (csrc/sweep_scan.cu, nvcc for sm_90a)
     and the native BAM ingest library, both from this checkout;
  3. kernel vs plain version on an adversarial case: blocks given to the
     sweep engine on the card, the kernel's inputs taken from the
     engine's own launch and held against sweep_scan_reference (exact
     int32 equality), the statistics against the numpy oracle;
  4. main path: the bench workload (32 contigs x 1 Mbp at 20x, 150 bp
     reads, ~4.27 M reads) as a sorted BGZF BAM, through the port's CLI
     `contig -b ... -m mean trimmed_mean variance covered_fraction` on
     the card: a warm-up run that records the inputs of every kernel
     launch and every engine batch, then a run with the kernel's launch
     count set to 0 just before and read just after; the TSV must equal
     the same command on the CPU (the plain path) and the per-contig
     statistics the numpy oracle's. The kernel is then held against its
     plain version on each recorded launch and timed there with CUDA
     events, and the recorded engine batches are replayed for the
     engine-only rate;
  5. genome mode: `genome -s '~'` on a smaller BAM (whole-file route),
     checked the same way.

Prints the card line, then one {"kernels": [...]} JSON line, then the
{"ok": true, "device": {...}} JSON line last.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

EE = 75
TRIM = (0.05, 0.95)
METHODS = ["mean", "trimmed_mean", "variance", "covered_fraction"]
H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA data sheet (SXM)
# INT32 peak: the data sheet's 67 TFLOP/s fp32 counts an FMA as two
# operations (33.5 T lane-instructions/s), and an SM has 64 INT32 lanes
# beside its 128 fp32 lanes
H100_INT32_OPS_PER_S = 67e12 / 2 * 64 / 128
# int32 operations per event of sweep_scan_reference, counted from its
# body (a lexmax step is 3: two compares and a select)
KERNEL_OPS_PER_EVENT = sum((
    1,      # sign scan
    1,      # sentinel test
    1 + 3,  # length fill: select, lexmax
    1 + 3,  # carry fill: select, lexmax
    1,      # depth
    2,      # gap end: test, select
    4,      # full_len: min, max, sub, clamp
    7,      # w_len: sub, min, max, sub, clamp, len > 2ee test, select
    3,      # padding: test, 2 selects
    3,      # covered: test, 2 selects
    3,      # window-max value: 2 tests, select
    3,      # window-max fill: lexmax
))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def cuda_ms(fn, reps):
    """Median milliseconds of fn() over reps runs, timed with CUDA events."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def blocks_of(tids, starts, lengths, read_len):
    ends = np.minimum(starts.astype(np.int64) + read_len, lengths[tids])
    return tids, starts.astype(np.int64), ends


@contextlib.contextmanager
def recording(module, name, store, copy):
    """Wrap module.<name> so that every call appends copy(args, kwargs)
    to store before running the original."""
    orig = getattr(module, name)

    def rec(*args, **kwargs):
        store.append(copy(args, kwargs))
        return orig(*args, **kwargs)
    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, orig)


def kernel_launches(store):
    """Records the six input tensors and ee of each sweep-scan call."""
    from coverm_tpu_torch.ops import sweep as S
    return recording(S, "sweep_scan", store,
                     lambda a, k: (tuple(t.clone() for t in a[:6]), a[6]))


def engine_batches(store):
    """Records (tids, starts, ends, contig_counts) of each engine batch."""
    from coverm_tpu_torch.ops import sweep as S

    def copy(a, k):
        counts = k.get("contig_counts")
        return (*(np.array(x) for x in a[1:4]),
                None if counts is None else np.array(counts))
    return recording(S, "compute_depth_stats_sweep", store, copy)


def check_kernel(name, ins, ee):
    """Kernel vs plain version on the card: exact equality of all six
    outputs; returns the largest absolute difference (0)."""
    import torch
    from coverm_tpu_torch.ops import sweep_scan as K
    got = K.sweep_scan(*ins, ee)
    want = K.sweep_scan_reference(*ins, ee)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    log(f"[kernel] {name}: E={ins[0].numel()} max_abs_err={err}")
    if err != 0:
        raise SystemExit(f"sweep-scan kernel disagrees with its plain "
                         f"version on {name}: max_abs_err={err}")
    return err


def check_adversarial(dev):
    """Contigs with no blocks, len <= 2*ee, blocks ending at the contig
    end, duplicate and zero-length blocks, tiles straddling contigs, a
    ragged event count: through the sweep engine on the card, whose
    kernel launch is held against the plain version and whose statistics
    against the numpy oracle."""
    from coverm_tpu_torch.ops.depth import (ReferenceLayout,
                                            compute_depth_stats_numpy)
    from coverm_tpu_torch.ops.sweep import compute_depth_stats_sweep
    rng = np.random.default_rng(7)
    lengths = np.array([120, 150, 151, 5000, 90, 3000, 7000, 40, 2500, 10000])
    blocks = []
    for c, ln in enumerate(lengths):
        if c in (1, 7):
            continue  # contigs with no blocks
        n = int(rng.integers(50, 900))
        s = rng.integers(0, ln, n)
        e = np.minimum(s + rng.integers(0, 300, n), ln)
        e[: n // 10] = ln  # blocks ending at the contig end
        blocks.append((np.full(n, c), s, e))
    tids = np.concatenate([b[0] for b in blocks])
    starts = np.concatenate([b[1] for b in blocks])
    ends = np.concatenate([b[2] for b in blocks])
    o = np.lexsort((starts, tids))
    tids, starts, ends = tids[o], starts[o], ends[o]
    layout = ReferenceLayout.build(lengths, EE)
    launches = []
    with kernel_launches(launches):
        got = compute_depth_stats_sweep(layout, tids, starts, ends,
                                        trim=TRIM, device=dev)
    if len(launches) != 1:
        raise SystemExit("adversarial case: expected one kernel launch")
    check_kernel("adversarial", *launches[0])
    check_stats("adversarial", got,
                compute_depth_stats_numpy(layout, tids, starts, ends,
                                          trim=TRIM))


def check_stats(label, got, want):
    for f in ("sum_depth_window", "covered_window", "covered_full",
              "max_depth_window", "sumsq_window", "min_depth_window",
              "trimmed_sum"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise SystemExit(f"{label}: {f} differs from the numpy oracle")


def oracle_check(label, bam, truth, argv, dev):
    """Per-contig DepthStats of the port's scan on the card against the
    numpy oracle on the known blocks; returns the oracle's."""
    from coverm_tpu_torch.cli import build_parser, flag_filter_from_args
    from coverm_tpu_torch.modes import BamFileSource
    from coverm_tpu_torch.ops.depth import (ReferenceLayout,
                                            compute_depth_stats_numpy)
    from coverm_tpu_torch.scan import scan_any
    tids, starts, ends = truth
    header, payload = BamFileSource(bam).read()
    layout = ReferenceLayout.build(header.target_lens, EE)
    ff = flag_filter_from_args(build_parser().parse_args(argv))
    scan = scan_any(header, payload, layout, ff, need_hist=False, trim=TRIM,
                    device=dev)
    want = compute_depth_stats_numpy(layout, tids, starts, ends, trim=TRIM)
    check_stats(label, scan.depth, want)
    if int(scan.reads_primary.sum()) != tids.size:
        raise SystemExit(f"{label}: read count differs")
    log(f"[{label}] DepthStats equal the numpy oracle on {tids.size} reads")
    return want


def run_cli(argv, out, device):
    from coverm_tpu_torch.cli import main
    rc = main(argv + ["-o", out], device=device)
    if rc != 0:
        raise SystemExit(f"CLI {argv[0]} exited {rc} on {device}")
    with open(out, "rb") as f:
        return f.read()


def main():
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this script "
            "needs an NVIDIA card")
        return 1
    from coverm_tpu_torch.io import native
    from coverm_tpu_torch.ops import sweep_scan as K
    from coverm_tpu_torch.ops.depth import ReferenceLayout
    from coverm_tpu_torch.ops.sweep import (DepthAccumulator,
                                            compute_depth_stats_sweep)
    from coverm_tpu_torch.synth import write_sorted_bam

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 1. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build: the kernel and the native ingest library together
    t0 = time.perf_counter()
    nat = threading.Thread(target=native.get_lib)
    nat.start()
    lib = K.build()
    nat.join()
    if native.get_lib() is None:
        raise SystemExit("native BAM ingest library did not build")
    build_s = time.perf_counter() - t0
    log(f"[build] {build_s:.1f} s; kernel {os.path.basename(lib)}")
    with open(lib + ".log") as f:
        log(f.read().strip())

    work = tempfile.mkdtemp(prefix="coverm_tpu_torch_smoke_")
    try:
        # fixture: the bench.py workload
        t0 = time.perf_counter()
        bam = os.path.join(work, "bench.bam")
        tids, starts, lengths = write_sorted_bam(bam)
        truth = blocks_of(tids, starts, lengths, 150)
        n_reads = tids.size
        log(f"[fixture] {n_reads} reads, "
            f"{os.path.getsize(bam) / 1e9:.3f} GB, "
            f"{time.perf_counter() - t0:.1f} s")

        # ---- 3. kernel vs plain version, adversarial case
        check_adversarial(dev)

        # ---- 4. main path at the bench size; the warm-up run records the
        # kernel's inputs and the engine's batches as the main path makes
        # them
        argv = ["contig", "-b", bam, "-m", *METHODS]
        launches_in, batches = [], []
        with kernel_launches(launches_in), engine_batches(batches):
            run_cli(argv, os.path.join(work, "warm.tsv"), dev)
        torch.cuda.synchronize()
        K.sweep_scan_launches = 0
        t0 = time.perf_counter()
        tsv_gpu = run_cli(argv, os.path.join(work, "gpu.tsv"), dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.sweep_scan_launches
        if launches <= 0:
            raise SystemExit("main path did not launch the sweep-scan kernel")
        if launches != len(launches_in):
            raise SystemExit(f"main path launched the kernel {launches} "
                             f"times, its warm-up {len(launches_in)}")
        tsv_cpu = run_cli(argv, os.path.join(work, "cpu.tsv"),
                          torch.device("cpu"))
        if tsv_gpu != tsv_cpu:
            raise SystemExit("contig TSV on the card differs from the CPU's")
        if tsv_gpu.count(b"\n") != 33:
            raise SystemExit("contig TSV does not have 32 contig rows")
        want = oracle_check("contig", bam, truth, argv, dev)

        # the kernel against its plain version at each main-path launch,
        # and its time there: sums over the launches of one main-path run
        err = 0
        kernel_ms = plain_ms = bytes_s = ops_s = 0.0
        events = []
        for i, (ins, ee) in enumerate(launches_in):
            err = max(err, check_kernel(f"main-path launch {i}", ins, ee))
            E = ins[0].numel()
            events.append(E)
            kernel_ms += cuda_ms(lambda: K.sweep_scan(*ins, ee), 30)
            plain_ms += cuda_ms(lambda: K.sweep_scan_reference(*ins, ee), 20)
            bytes_s += 12 * 4 * E / H100_BYTES_PER_S
            ops_s += KERNEL_OPS_PER_EVENT * E / H100_INT32_OPS_PER_S
        bound_ms = max(bytes_s, ops_s) * 1e3
        bound_by = "bytes" if bytes_s >= ops_s else "operations"
        log(f"[kernel] {launches} launches, E {events}: kernel "
            f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}; bytes {bytes_s * 1e3:.4f} ms, "
            f"operations {ops_s * 1e3:.4f} ms); {card}")

        # engine-only: the main path's own batches, from decoded block
        # arrays, folded into one accumulator
        layout = ReferenceLayout.build(lengths, EE)

        def device_pass():
            acc = DepthAccumulator()
            for bt, bs, be, counts in batches:
                compute_depth_stats_sweep(layout, bt, bs, be, trim=TRIM,
                                          acc=acc, contig_counts=counts,
                                          device=dev)
            acc.start_fetch()
            return acc.result()
        check_stats("engine-only", device_pass(), want)
        t0 = time.perf_counter()
        device_pass()
        device_s = time.perf_counter() - t0
        log(f"[main path] {n_reads} reads: decode-inclusive "
            f"{n_reads / wall:.0f} reads/s ({wall:.3f} s), engine-only "
            f"{n_reads / device_s:.0f} reads/s ({device_s:.3f} s, "
            f"{len(batches)} batches), {launches} kernel launches; {card}")

        # ---- 5. genome mode, whole-file route
        gbam = os.path.join(work, "genome.bam")
        names = [f"g{i % 3}~c{i}" for i in range(8)]
        gt, gs, gl = write_sorted_bam(gbam, n_contigs=8, contig_len=100_000,
                                      seed=1, names=names)
        gargv = ["genome", "-s", "~", "-b", gbam, "-m", *METHODS]
        g_before = K.sweep_scan_launches
        g_gpu = run_cli(gargv, os.path.join(work, "g_gpu.tsv"), dev)
        if K.sweep_scan_launches <= g_before:
            raise SystemExit("genome mode did not launch the kernel")
        g_cpu = run_cli(gargv, os.path.join(work, "g_cpu.tsv"),
                        torch.device("cpu"))
        if g_gpu != g_cpu or g_gpu.count(b"\n") != 4:
            raise SystemExit("genome TSV on the card differs from the CPU's")
        oracle_check("genome", gbam, blocks_of(gt, gs, gl, 150), gargv, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "sweep_scan",
        "route": "cuda",
        "source": "coverm_tpu_torch/csrc/sweep_scan.cu",
        "replaces": "coverm_tpu/ops/pallas_sweep.py:107",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the sweep scan",
        "events_per_launch": events,
        "build_s": build_s,
        "decode_inclusive_reads_per_s": n_reads / wall,
        "device_only_reads_per_s": n_reads / device_s,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
