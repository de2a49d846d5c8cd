"""A/B of the card's record scan over the segments of a BAM.

The BAM is cut as the fused scan cuts it (io/fastscan.FusedScanStream's
plan and plan_segments, segments of about --segment-bytes inflated), each
segment inflated into a card slot after the carry
(ops/bgzf_inflate.SegmentInflater) and scanned by
ops/bam_scan.scan_segment under the default flag filter, timed with CUDA
events around the call and by step (the scan's own timing: speculate, the
stitch's check and walk, analyse, fold, emit, the copy back under
`d2h`). A pass over the file warms up, the next is kept.

Each version runs in a process of its own, on one card, in turns
(NAME, this, this, NAME): this checkout, and with --other NAME=DIR
another checkout of the port (a parent unpacked with `git archive` into
a directory that .gitignore lists, such as .smoke_tree/), whose package
the child imports (PYTHONPATH=DIR) and whose kernels it builds. With
--sub-log NAME=N, a copy of this checkout's package under
.smoke_tree/NAME whose speculate gives each lane a sub-range of 2**N
bytes (csrc/bam_scan.cu kLogSub, ops/bam_scan.SUB) runs in turn too.

Run:  python -m coverm_tpu_torch.scripts.scan_ab X.bam
          [--other parent=DIR] [--sub-log sub4k=12] [--segment-bytes N]
Prints one JSON line a run, then one with them all.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys


def measure(path, seg_bytes):
    """Two passes over the file's segments in this process, the second
    kept: {ms, step_ms, segments, records}."""
    import numpy as np
    import torch
    from coverm_tpu_torch.flags import FlagFilter
    from coverm_tpu_torch.io.fastscan import (_CARD_HEADROOM,
                                              FusedScanStream, plan_segments)
    from coverm_tpu_torch.ops import bam_scan as S
    from coverm_tpu_torch.ops import bgzf_inflate as B

    dev = torch.device("cuda")
    skip, req = FlagFilter().masks()
    for _ in range(2):
        stream = FusedScanStream(path, seg_bytes)
        header = stream.open()
        mm, off, csz, usz, carry, j = stream._plan
        segments = plan_segments(usz, j, stream.target_bytes)
        out = {"ms": 0.0, "step_ms": {}, "segments": len(segments),
               "records": 0}
        inf = B.SegmentInflater(path, off, csz, usz, segments,
                                _CARD_HEADROOM, dev)
        carry = torch.from_numpy(np.ascontiguousarray(carry)).to(dev) \
            if carry is not None and len(carry) else None
        try:
            inf.start(0)
            for k in range(len(segments)):
                if k + 1 < len(segments):
                    inf.start(k + 1)
                slot, lo, hi = inf.take(k, carry)
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                sc = S.scan_segment(slot, lo, hi, header.n_ref, skip, req,
                                    timing=True)
                ev[1].record()
                ev[1].synchronize()
                out["ms"] += ev[0].elapsed_time(ev[1])
                for key, v in sc.timing.items():
                    out["step_ms"][key] = out["step_ms"].get(key, 0.0) + v
                out["records"] += sc.n_records
                carry = sc.tail
                del slot, sc
        finally:
            inf.close()
    return out


def sub_log_tree(here, name, log2):
    """A copy of this checkout's package under .smoke_tree/NAME whose
    speculate gives each lane 2**log2 bytes; returns its directory."""
    dst = os.path.join(here, ".smoke_tree", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(here, "coverm_tpu_torch"),
                    os.path.join(dst, "coverm_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__",
                                                  "*.so", "*.so.*"))
    for rel, pat, new in (
            ("csrc/bam_scan.cu", r"constexpr int kLogSub = \d+;",
             f"constexpr int kLogSub = {int(log2)};"),
            ("ops/bam_scan.py", r"SUB = 1 << \d+", f"SUB = 1 << {int(log2)}")):
        p = os.path.join(dst, "coverm_tpu_torch", rel)
        with open(p) as f:
            text, n = re.subn(pat, new, f.read())
        if n != 1:
            raise RuntimeError(f"scan_ab: {rel} has no {pat}")
        with open(p, "w") as f:
            f.write(text)
    return dst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("bam")
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR: another checkout of the port")
    ap.add_argument("--sub-log", action="append", default=[],
                    help="NAME=N: this checkout with 2**N-byte sub-ranges")
    ap.add_argument("--segment-bytes", type=int, default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(measure(args.bam, args.segment_bytes)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("scan_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    from .common import result_line, runs_in_turns
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    trees = dict(o.split("=", 1) for o in args.other)
    for o in args.sub_log:
        name, log2 = o.split("=", 1)
        trees[name] = sub_log_tree(here, name, log2)
    child = [os.path.abspath(args.bam)]
    if args.segment_bytes:
        child += ["--segment-bytes", str(args.segment_bytes)]
    runs = runs_in_turns(__file__, trees, child)
    if runs is None:
        return 1
    print(result_line(torch.device("cuda"), bam=args.bam, runs=runs))
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv:
        sys.exit(main())
    from coverm_tpu_torch.scripts.scan_ab import main as _main
    sys.exit(_main())
