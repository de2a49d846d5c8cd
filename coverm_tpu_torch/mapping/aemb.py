"""`-m strobealign-aemb`: abundance shortcut via strobealign --aemb
(strobealign_aemb.rs).  Runs the mapper per readset and streams its
2-column TSV straight into the taker, bypassing the estimator suite."""

from __future__ import annotations

import subprocess

from .external import check_for_strobealign
from .params import MappingParameters
from .pipeline import _resolve_references, name_stoit


def strobealign_aemb_coverage(args, estimators_and_taker, stream):
    check_for_strobealign()
    refs, _tmp = _resolve_references(args)
    params = MappingParameters.generate_from_args(args, refs)
    taker = estimators_and_taker.taker
    results = []
    for ref, jobs in params.references:
        for job in jobs:
            cmd = (f"strobealign --aemb -t {job.threads} '{ref}' "
                   f"'{job.read1}' '{job.read2 or ''}'")
            res = subprocess.run(["bash", "-c", cmd], capture_output=True,
                                 text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"strobealign --aemb command '{cmd}' failed: {res.stderr[-2000:]}")
            results.append((name_stoit(ref, job.read1, True), res.stdout))

    for stoit_name, tsv in results:
        taker.start_stoit(stoit_name)
        for i, line in enumerate(l for l in tsv.split("\n") if l):
            cols = line.split("\t")
            if len(cols) != 2:
                raise RuntimeError(
                    f"Unexpected number of columns in strobealign-aemb "
                    f"mapping result line {i}: {cols}")
            taker.start_entry(i, cols[0])
            taker.add_single_coverage(float(cols[1]))
            taker.finish_entry()
    estimators_and_taker.printer.finalise_printing(
        taker, stream, None, [], None, None)
    return 0
