"""Multi-process scaling benchmark for the contig-sharded mesh sweep.

Measures aligned reads/s of the depth engine through
parallel/distributed.compute_depth_stats_sweep_multihost over 1 rank and
over N ranks, one card each (one logical CPU device each on the CPU), and
reports the strong-scaling efficiency

    eff(N) = rps(N) / (N * rps(1))

against a target of 0.8. Each rank takes one card: with at least N
cards, the ranks of an N-rank job see the first N (CUDA_VISIBLE_DEVICES),
of which device.card_share gives rank r card r, since a lone rank would
otherwise take every card of its host; with fewer, the ranks share the
cards, each taking one. The ranks join over torch.distributed through
COVERM_TPU_COORDINATOR, _NUM_PROCESSES and _PROCESS_ID; the backend
(`transport`) is the one maybe_initialize picks: NCCL when every rank
has a card of its own, gloo when ranks share one (or on the CPU). The
cross-rank merge is one all-reduce of the packed statistics (a few
hundred int64) a pass.

Run:  python -m coverm_tpu_torch.scripts.scaling_bench [--nproc 2]
          [--reads 2000000] [--device cpu]
Prints rank 0's line of each launch and, last, one JSON line. Every rank
runs under --timeout seconds; a rank that fails fails the run.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

from .common import add_device_arg, result_line

N_CONTIGS = 64
CONTIG_LEN = 400_000
READ_LEN = 150
REPS = 5
TRIM = (0.05, 0.95)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_workload(n_reads):
    rng = np.random.default_rng(0)
    tids = np.sort(rng.integers(0, N_CONTIGS, n_reads)).astype(np.int64)
    starts = (rng.random(n_reads) * (CONTIG_LEN - READ_LEN)).astype(np.int64)
    order = np.lexsort((starts, tids))
    tids, starts = tids[order], starts[order]
    return tids, starts, starts + READ_LEN


def worker(reads: int) -> int:
    """One rank: a warm-up pass, then REPS timed passes; rank 0 prints
    its JSON line. The sweep-scan kernel's launches are counted over the
    whole worker."""
    import torch.distributed as dist

    from ..ops import sweep_scan as K
    from ..ops.depth import ReferenceLayout
    from ..parallel import distributed

    if not distributed.maybe_initialize():
        raise RuntimeError("a worker needs COVERM_TPU_COORDINATOR, "
                           "_NUM_PROCESSES and _PROCESS_ID")
    K.sweep_scan_launches = 0
    tids, starts, ends = build_workload(reads)
    layout = ReferenceLayout.build(
        np.full(N_CONTIGS, CONTIG_LEN, dtype=np.int64), 75)
    mesh = distributed.make_global_mesh()

    def one_pass():
        d = distributed.compute_depth_stats_sweep_multihost(
            layout, tids, starts, ends, need_hist=False, trim=TRIM,
            mesh=mesh)
        return int(d.sum_depth_window.sum())

    total = one_pass()  # warm-up: first launches, gloo or NCCL set-up
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        one_pass()
        times.append(time.perf_counter() - t0)
    launches = [None] * dist.get_world_size()
    dist.all_gather_object(launches, K.sweep_scan_launches)
    med = float(np.median(times))
    if dist.get_rank() == 0:
        print(json.dumps({
            "n_processes": dist.get_world_size(),
            "n_devices": len(mesh[0]),
            "devices": [f"rank {r} {d}" for r, d in mesh[0]],
            "transport": dist.get_backend(),
            "reads_per_s": reads / med,
            "median_s": med,
            "times_s": times,
            "checksum": total,
            "k1_launches_by_rank": launches,
        }), flush=True)
    return 0


def rank_env(base, rank, nproc, port, device_type, n_cards, cpu_threads=1):
    """The environment of rank `rank` of an nproc-rank job: the
    coordinator trio, and one device: on the CPU one logical device of
    `cpu_threads` threads; on a host of n_cards >= nproc cards the first
    nproc of them (of those CUDA_VISIBLE_DEVICES lists, when set), of
    which device.card_share gives each rank its own; with fewer cards,
    all of them, of which card_share gives the rank one, shared."""
    env = {k: v for k, v in base.items() if not k.startswith("COVERM_TPU")}
    env.update(COVERM_TPU_COORDINATOR=f"localhost:{port}",
               COVERM_TPU_NUM_PROCESSES=str(nproc),
               COVERM_TPU_PROCESS_ID=str(rank),
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, base.get("PYTHONPATH")) if p))
    if device_type == "cpu":
        env.update(COVERM_TPU_TORCH_DEVICE="cpu",
                   COVERM_TPU_TORCH_CPU_DEVICES="1",
                   OMP_NUM_THREADS=str(cpu_threads))
    elif n_cards >= nproc:
        visible = base.get("CUDA_VISIBLE_DEVICES")
        cards = (visible.split(",") if visible
                 else [str(i) for i in range(n_cards)])
        env["CUDA_VISIBLE_DEVICES"] = ",".join(cards[:nproc])
    return env


def launch(nproc, reads, device_type, n_cards, timeout, cmd=None,
           cpu_threads=1):
    """Run an nproc-rank job of worker(reads), each rank as `cmd +
    ["--reads", str(reads)]` (default: this module with --worker), with
    rank_env's environment.
    Returns rank 0's JSON and every rank's standard error; raises when a
    rank fails or overruns `timeout` seconds (all are killed then)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = cmd or [sys.executable, "-m", "coverm_tpu_torch.scripts."
                  "scaling_bench", "--worker"]
    with tempfile.TemporaryDirectory() as logs:
        outs = [open(os.path.join(logs, f"{r}.out"), "w+")
                for r in range(nproc)]
        errs = [open(os.path.join(logs, f"{r}.err"), "w+")
                for r in range(nproc)]
        procs = []
        deadline = time.monotonic() + timeout
        try:
            for r in range(nproc):
                procs.append(subprocess.Popen(
                    [*cmd, "--reads", str(reads)], cwd=ROOT,
                    stdout=outs[r], stderr=errs[r],
                    env=rank_env(os.environ, r, nproc, port, device_type,
                                 n_cards, cpu_threads)))
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"a rank of the {nproc}-rank job ran over "
                               f"{timeout} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            said = []
            for f in outs + errs:
                f.seek(0)
                said.append(f.read())
                f.close()
    stdout, stderr = said[:nproc], said[nproc:]
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {nproc} exited {p.returncode}:"
                               f"\n{stderr[r][-4000:]}")
    lines = [l for l in stdout[0].splitlines() if l.startswith("{")]
    if not lines:
        raise RuntimeError(f"rank 0 of {nproc} printed no result")
    return json.loads(lines[-1]), stderr


def run(nproc, reads, device, timeout=1800, cmd=None, out=print):
    """eff(nproc) against one rank, at `reads` reads, on `device`'s type:
    (the launcher's record, every rank's standard error)."""
    import torch
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    # on the CPU a logical device is a fixed share of the cores in both
    # jobs, so that N ranks add compute as N cards would
    threads = max((os.cpu_count() or 1) // nproc, 1)
    r1, err1 = launch(1, reads, device.type, n_cards, timeout, cmd, threads)
    out(json.dumps(r1))
    rn, errn = launch(nproc, reads, device.type, n_cards, timeout, cmd,
                      threads)
    out(json.dumps(rn))
    if r1["checksum"] != rn["checksum"]:
        raise RuntimeError(f"checksums differ: {r1['checksum']} on one "
                           f"rank, {rn['checksum']} on {nproc}")
    eff = rn["reads_per_s"] / (nproc * r1["reads_per_s"])
    if device.type == "cpu":
        cards = f"one logical CPU device of {threads} threads a rank"
    elif n_cards >= nproc:
        cards = "one card a rank (the first N cards visible)"
    else:
        cards = f"{nproc} ranks sharing {n_cards} card(s)"
    return {
        "metric": "multi-process strong-scaling efficiency (mesh sweep, "
                  "one device a process)",
        "reads": reads,
        "rps_1proc": r1["reads_per_s"],
        f"rps_{nproc}proc": rn["reads_per_s"],
        "efficiency": eff,
        "target": 0.8,
        "checksum": rn["checksum"],
        "transport": rn["transport"],
        "cards": n_cards,
        "rank_devices": cards,
        "k1_launches_by_rank": {"1": r1["k1_launches_by_rank"],
                                str(nproc): rn["k1_launches_by_rank"]},
    }, err1 + errn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true",
                    help="run as one rank (set by the launcher)")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--reads", type=int, default=2_000_000)
    ap.add_argument("--timeout", type=float, default=1800,
                    help="seconds each launch may take")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.reads)
    from ..device import resolve_device
    dev = resolve_device(args.device)
    res, _ = run(args.nproc, args.reads, dev, args.timeout)
    print(result_line(dev, tool="scaling_bench", **res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
