"""Where the main path's time goes on the card.

    python -m coverm_tpu_torch.breakdown

Writes the bench workload (synth.write_sorted_bam's defaults: 32 contigs
x 1 Mbp at 20x, 150 bp reads) as a sorted BGZF BAM in a temporary
directory, runs `contig -b ... -m mean trimmed_mean variance
covered_fraction` through the CLI on the card once to warm up, once
under a host clock, and once under torch.profiler. Prints one JSON
object: the card, the wall time, the device's busy time and idle share
over the profiled run, and device milliseconds by layer (the event
sort, the sweep-scan kernel, cumsums, gathers and searches, copies, the
rest) and the TOP_KERNELS kernels by device time. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import time

import torch

METHODS = ["mean", "trimmed_mean", "variance", "covered_fraction"]
TOP_KERNELS = 15

# layer of a device activity, by the first pattern its name contains
LAYERS = [("sweep_scan_kernel", "sweep-scan kernel (K1)"),
          ("memcpy htod", "h2d copy"), ("memcpy dtoh", "d2h copy"),
          ("memset", "memset"), ("sort", "event sort"),
          ("scan", "cumsum / cummax"), ("index", "gather / scatter"),
          ("gather", "gather / scatter"), ("search", "searchsorted"),
          ("repeat", "repeat_interleave")]


def _layer(name: str) -> str:
    low = name.lower()
    for pat, layer in LAYERS:
        if pat in low:
            return layer
    return "other elementwise"


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("breakdown: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from .cli import main as cli_main
    from .synth import write_sorted_bam

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    work = tempfile.mkdtemp(prefix="coverm_tpu_torch_breakdown_")
    try:
        bam = os.path.join(work, "bench.bam")
        tids, _, _ = write_sorted_bam(bam)
        argv_ = ["contig", "-q", "-b", bam, "-m", *METHODS, "-o",
                 os.path.join(work, "out.tsv")]
        cli_main(argv_, device=dev)  # warm-up: kernel build, first launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_main(argv_, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cli_main(argv_, device=dev)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)

    by_kernel, by_layer = {}, {}
    busy_us = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy_us += us
        n, t = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, t + us)
        layer = _layer(e.name)
        by_layer[layer] = by_layer.get(layer, 0.0) + us
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    print(json.dumps({
        "card": card,
        "reads": int(tids.size),
        "wall_s": wall,
        "decode_inclusive_reads_per_s": tids.size / wall,
        "profiled_wall_s": prof_wall,
        "device_busy_s": busy_us / 1e6 if busy_us else None,
        "device_idle_share": 1 - busy_us / 1e6 / prof_wall if busy_us
        else None,
        "device_ms_by_layer": {k: v / 1e3 for k, v in sorted(
            by_layer.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": k[:100], "launches": n, "ms": t / 1e3}
                        for k, (n, t) in top],
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
