"""Cross-validation of engine outputs on any reference-sorted BAM — the
analogue of the reference's validate.R, which checks
coverage_histogram x depth against mean and genome lengths against the
BAM header on a user-supplied BAM.

Checks, per contig:
  1. sum(depth * bases_at_depth) / window_length == mean (f32 tolerance)
  2. sum(bases_at_depth) == window_length (histogram covers every base)
  3. `length` output == BAM header target length

Usage: python -m coverm_tpu_torch.scripts.validate [--device cpu]
           <sorted.bam> [more.bam ...]
Exit 0 when every check passes, 1 on any failure, 2 with no BAM.
"""

import argparse
import os
import sys

import numpy as np

from .common import add_device_arg, result_line


def validate(path: str, device=None, out=print):
    """Check one BAM on `device` (default: the card); print a FAIL line
    for each failing contig and a summary line, as the JAX package's
    scripts/validate.py does. Returns (failures, contigs checked, primary
    alignments)."""
    from ..flags import FlagFilter
    from ..modes import BamFileSource
    from ..ops.depth import ReferenceLayout
    from ..scan import scan_any

    src = BamFileSource(path)
    header, payload = src.read()
    try:
        ee = 0  # validate over full contigs (validate.R uses no exclusion)
        layout = ReferenceLayout.build(header.target_lens, ee)
        scan = scan_any(header, payload, layout, FlagFilter(),
                        need_hist=True, device=device)
    finally:
        src.finish()

    lens = header.target_lens
    d = scan.depth
    bad = 0
    hist = d.hist if d.hist is not None else np.zeros((len(lens), 1),
                                                      np.int64)
    wide = d.hist_wide or {}
    for c in range(len(lens)):
        if not scan.observed[c]:
            continue
        L = int(lens[c])
        h = wide.get(c, hist[c])
        depths = np.arange(h.size, dtype=np.float64)
        hist_total = int(h.sum())
        if hist_total != L:
            out(f"FAIL {header.target_names[c]}: histogram covers "
                f"{hist_total} bases, contig length {L}")
            bad += 1
            continue
        mean_from_hist = float((depths * h).sum()) / L
        mean_direct = float(d.sum_depth_window[c]) / L
        if not np.isclose(mean_from_hist, mean_direct, rtol=1e-6, atol=1e-9):
            out(f"FAIL {header.target_names[c]}: histogram mean "
                f"{mean_from_hist} != direct mean {mean_direct}")
            bad += 1
    n_obs = int(scan.observed.sum())
    n_primary = scan.num_detected_primary_alignments
    out(f"{os.path.basename(path)}: {n_obs} covered contigs checked, "
        f"{bad} failures ({n_primary} primary alignments)")
    return bad, n_obs, n_primary


def main(argv=None) -> int:
    """Standard output is byte for byte that of scripts/validate.py; the
    JSON line goes last to standard error."""
    p = argparse.ArgumentParser(add_help=True)
    p.add_argument("bams", nargs="*")
    add_device_arg(p)
    args = p.parse_args(argv)
    if not args.bams:
        print(__doc__)
        return 2
    from ..device import resolve_device
    dev = resolve_device(args.device)
    per_bam, total_bad = [], 0
    for path in args.bams:
        bad, n_obs, n_primary = validate(path, dev)
        total_bad += bad
        per_bam.append({"bam": path, "contigs_checked": n_obs,
                        "failures": bad, "primary_alignments": n_primary})
    print(result_line(dev, tool="validate", bams=per_bam,
                      failures=total_bad), file=sys.stderr)
    return 1 if total_bad else 0


if __name__ == "__main__":
    sys.exit(main())
