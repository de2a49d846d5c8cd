"""Where the main path's time goes on the card.

    python -m coverm_tpu_torch.breakdown

Writes the bench workload (synth.write_sorted_bam's defaults: 32 contigs
x 1 Mbp at 20x, 150 bp reads) in a temporary directory as a sorted BGZF
BAM, as its CRAM twin (synth.write_cram_twin) and with a GFF of a 900 bp
gene every 1,000 bp (synth.write_gene_gff), and drives three routes
through the CLI on the card with `-m mean trimmed_mean variance
covered_fraction`: `contig -b bench.bam`, `contig -b bench.cram` and
`contig --gff genes.gff -b bench.bam`. Each runs once to warm up, once
under a host clock, and once under torch.profiler. Prints one JSON
object: the card and, for each route, the wall time, the sweep-scan
kernel's launches, the device's busy time and idle share over the
profiled run, device milliseconds by layer (the sorts, the sweep-scan
kernel, cumsums, gathers, searches, repeat_interleave, copies, the
rest) and the TOP_KERNELS kernels by device time. Needs a CUDA device.
The routes run on cuda:0 alone, so that on a machine with several cards
they measure the single-card engine and not the multi-device ones.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import torch

METHODS = ["mean", "trimmed_mean", "variance", "covered_fraction"]
TOP_KERNELS = 15

# layer of a device activity, by the first pattern its name contains:
# "search" before "sort" (searchsorted_cuda_kernel), and PyTorch's
# repeat_interleave kernel (compute_cuda_kernel) by its own name. The
# event sort and the trimmed-mean re-sort launch the same radix-sort
# kernels, so they share one layer.
LAYERS = [("sweep_scan_kernel", "sweep-scan kernel (K1)"),
          ("memcpy htod", "h2d copy"), ("memcpy dtoh", "d2h copy"),
          ("memset", "memset"), ("search", "searchsorted"),
          ("sort", "sorts (event + trimmed-mean)"),
          ("scan", "cumsum / cummax"), ("index", "gather / scatter"),
          ("gather", "gather / scatter"),
          ("compute_cuda_kernel", "repeat_interleave"),
          ("repeat", "repeat_interleave")]


def _layer(name: str) -> str:
    low = name.lower()
    for pat, layer in LAYERS:
        if pat in low:
            return layer
    return "other elementwise"


def _route(argv, n_reads, dev):
    """Warm-up, timed and profiled runs of one CLI route -> its record."""
    from torch.profiler import ProfilerActivity, profile

    from .cli import main as cli_main
    from .ops import sweep_scan as K

    cli_main(argv, device=dev)  # warm-up: kernel build, first launches
    torch.cuda.synchronize()
    K.sweep_scan_launches = 0
    t0 = time.perf_counter()
    cli_main(argv, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.sweep_scan_launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cli_main(argv, device=dev)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0

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
    return {
        "wall_s": wall,
        "decode_inclusive_reads_per_s": n_reads / wall,
        "sweep_scan_launches": launches,
        "profiled_wall_s": prof_wall,
        "device_busy_s": busy_us / 1e6 if busy_us else None,
        "device_idle_share": 1 - busy_us / 1e6 / prof_wall if busy_us
        else None,
        "device_ms_by_layer": {k: v / 1e3 for k, v in sorted(
            by_layer.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": k[:100], "launches": n, "ms": t / 1e3}
                        for k, (n, t) in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("breakdown: needs a CUDA device")
    from .synth import write_cram_twin, write_gene_gff, write_sorted_bam
    from .timing import card_line

    card = card_line()
    dev = torch.device("cuda", 0)  # one named card: local_devices is [it]
    work = tempfile.mkdtemp(prefix="coverm_tpu_torch_breakdown_")
    try:
        bam = os.path.join(work, "bench.bam")
        cram = os.path.join(work, "bench.cram")
        gff = os.path.join(work, "genes.gff")
        tids, _, lengths = write_sorted_bam(bam)
        write_cram_twin(cram)
        n_genes = write_gene_gff(gff, [f"c{i}" for i in range(lengths.size)],
                                 int(lengths[0]))
        common = ["-q", "-m", *METHODS, "-o", os.path.join(work, "out.tsv")]
        routes = {
            "contig_bam": ["contig", "-b", bam, *common],
            "contig_cram": ["contig", "-b", cram, *common],
            "contig_gff": ["contig", "--gff", gff, "-b", bam, *common],
        }
        out = {name: _route(argv, int(tids.size), dev)
               for name, argv in routes.items()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"card": card, "reads": int(tids.size),
                      "genes": n_genes, "routes": out}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
