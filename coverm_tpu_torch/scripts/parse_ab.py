"""A/B of the card's record parse over the segments of a BAM.

The BAM is cut as the classic reader cuts it (io/fastscan.plan_segments
from the file's first block, segments of about --segment-bytes inflated),
each segment inflated into a card slot after the carry
(ops/bgzf_inflate.SegmentInflater) and parsed by ops/bam_scan.parse_segment
twice: without the slot's bytes (`bare`, as `--gff` parses) and with them
(`kept`, as the pair filters, `filter` and the shard merge parse). Each
parse is timed with CUDA events around the call and by step (the
parse's own timing, the copy back under `d2h`), and the card's peak
around it is read (max_memory_allocated after reset_peak_memory_stats;
`above`, the peak less what was allocated before the call). A pass over
the file warms up, the next is kept.

Each version runs in a process of its own, on one card, in turns
(NAME, this, this, NAME): this checkout, and with --other NAME=DIR
another checkout of the port (a parent unpacked with `git archive` into
a directory that .gitignore lists, such as .smoke_tree/), whose package
the child imports (PYTHONPATH=DIR) and whose kernels it builds.

Run:  python -m coverm_tpu_torch.scripts.parse_ab X.bam
          [--other parent=DIR] [--segment-bytes N]
Prints one JSON line a run, then one with them all.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROUTES = {"bare": False, "kept": True}


def measure(path, seg_bytes):
    """Two passes over the file's segments in this process, the second
    kept: {route: {ms, step_ms, peak, above}, segments, records}."""
    import numpy as np
    import torch
    from coverm_tpu_torch.io import bam as IB
    from coverm_tpu_torch.io import native
    from coverm_tpu_torch.io.fastscan import _CARD_HEADROOM, plan_segments
    from coverm_tpu_torch.ops import bam_scan as S
    from coverm_tpu_torch.ops import bgzf_inflate as B

    dev = torch.device("cuda")
    mm = np.memmap(path, np.uint8, mode="r")
    off, csz, usz = native.bgzf_scan(mm)
    segments = plan_segments(usz, 0, seg_bytes)
    for _ in range(2):
        out = {r: {"ms": 0.0, "step_ms": {}, "peak": 0, "above": 0}
               for r in ROUTES}
        out["segments"] = len(segments)
        out["records"] = 0
        inf = B.SegmentInflater(path, off, csz, usz, segments,
                                _CARD_HEADROOM, dev)
        carry, n_ref = None, None
        try:
            inf.start(0)
            for k in range(len(segments)):
                if k + 1 < len(segments):
                    inf.start(k + 1)
                slot, lo, hi = inf.take(k, carry)
                torch.cuda.synchronize()
                start = lo
                if n_ref is None:
                    header, hdr = IB._parse_header(
                        slot[lo:hi].cpu().numpy())
                    n_ref, start = header.n_ref, lo + hdr
                for route, keep in ROUTES.items():
                    r = out[route]
                    torch.cuda.synchronize()
                    resident = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                    ps = S.parse_segment(slot, start, hi, n_ref,
                                         timing=True, base=lo,
                                         keep_bytes=keep)
                    ev[1].record()
                    ev[1].synchronize()
                    peak = torch.cuda.max_memory_allocated(dev)
                    r["peak"] = max(r["peak"], peak)
                    r["above"] = max(r["above"], peak - resident)
                    r["ms"] += ev[0].elapsed_time(ev[1])
                    for key, v in ps.timing.items():
                        r["step_ms"][key] = r["step_ms"].get(key, 0.0) + v
                out["records"] += ps.n_records
                # the kept route's bytes hold the carry in every version
                carry = ps.data[ps.end_off:]
                del slot, ps
        finally:
            inf.close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("bam")
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR: another checkout of the port")
    ap.add_argument("--segment-bytes", type=int, default=1 << 28)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(measure(args.bam, args.segment_bytes)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("parse_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    from .common import result_line, runs_in_turns
    runs = runs_in_turns(__file__, dict(o.split("=", 1) for o in args.other),
                         [os.path.abspath(args.bam), "--segment-bytes",
                          str(args.segment_bytes)])
    if runs is None:
        return 1
    print(result_line(torch.device("cuda"), bam=args.bam, runs=runs))
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv:
        sys.exit(main())
    from coverm_tpu_torch.scripts.parse_ab import main as _main
    sys.exit(_main())
