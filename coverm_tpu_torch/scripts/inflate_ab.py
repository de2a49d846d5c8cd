"""A/B of the card's BGZF inflate kernel over the segments of BAMs.

Each BAM is cut as the fused ingest cuts it (io/fastscan.plan_segments:
the header probe's blocks, then segments of about 256 MiB inflated). Each
segment is staged once in pinned host memory and inflated by every
variant in turns, forward then backward (parent, kernel, kernel,
parent):

  kernel       this checkout's kernel, through ops/bgzf_inflate.py
  kernel@card  the same with its input and output in the card's memory
               (the buffers copied there), the host link out of the way:
               its time beside kernel's splits decoding from the link
  NAME         another source of the kernel (--other NAME=PATH, such as
               a parent checkout's csrc/bgzf_inflate.cu), built with the
               same flags and called through its bgzf_inflate_launch

Every launch is timed with CUDA events and its bytes held against the
host's ct_bgzf_inflate; a variant's time for a segment is the mean of its
two turns. Segments are told apart by their records, in the repo's
synthetic BAMs (bench_torch/synth.py, coverm_tpu_torch/synth.py):
`unmapped` when every record there is an unmapped one (refID and pos -1,
bin 4680), `mapped` when none is, else `mixed`.

Run:  python -m coverm_tpu_torch.scripts.inflate_ab X.bam [Y.bam ...]
          [--other parent=OTHER/csrc/bgzf_inflate.cu ...]
          [--variants parent,kernel,kernel@card]
Prints one JSON line a BAM, then one with them all.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from .common import result_line

# an unmapped record's refID, pos, l_read_name 10, MAPQ 0 and bin 4680;
# every record's next refID and next pos (-1) and TLEN 0
UNMAPPED = bytes.fromhex("ffffffffffffffff0a004812")
RECORD = bytes.fromhex("ffffffffffffffff00000000")


def segments_of(bam):
    """(mm, off, csz, usz, segments) of the fused ingest's plan."""
    from ..io.fastscan import FusedScanStream, plan_segments
    stream = FusedScanStream(bam)
    stream.open()
    mm, off, csz, usz, _carry, j = stream._plan
    return mm, off, csz, usz, plan_segments(usz, j, stream.target_bytes)


def kind(data: bytes) -> str:
    unmapped, records = data.count(UNMAPPED), data.count(RECORD)
    if unmapped == 0:
        return "mapped"
    return "unmapped" if unmapped >= records else "mixed"


def other_launcher(source):
    """A launch through another source's bgzf_inflate_launch."""
    from ..ops import cuda_build
    lib = ctypes.CDLL(cuda_build.build(source))
    vp = ctypes.c_void_p
    lib.bgzf_inflate_launch.restype = ctypes.c_int
    lib.bgzf_inflate_launch.argtypes = [vp] * 4 + [
        ctypes.c_longlong, ctypes.c_int, vp]

    def launch(comp, table, out, status, dev):
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        err = lib.bgzf_inflate_launch(
            comp.data_ptr(), table.data_ptr(), out.data_ptr(),
            status.data_ptr(), table.shape[0], index,
            torch.cuda.current_stream(index).cuda_stream)
        if err:
            raise RuntimeError(f"inflate kernel of {source} failed: {err}")
    return launch


def launchers(names, others=None):
    """name -> launch(comp, table, out, status, dev): kernel and
    kernel@card from this checkout, the others from their sources (name
    -> path)."""
    from ..ops import bgzf_inflate as B
    out = {}
    for name in names:
        if name in (others or {}):
            out[name] = other_launcher(others[name])
        elif name == "kernel":
            out[name] = B.bgzf_inflate
        else:  # the wrapper takes pinned host memory only
            out[name] = other_launcher(B.SOURCE)
    return out


def staged(mm, off, csz, usz, i, k):
    """Pinned (comp, table, out, status) of blocks i..k."""
    from ..ops import bgzf_inflate as B
    lo, hi = int(off[i]), int(off[k - 1] + csz[k - 1])
    comp = torch.zeros(hi - lo + B.PAD, dtype=torch.uint8, pin_memory=True)
    comp.numpy()[:hi - lo] = mm[lo:hi]
    table = torch.from_numpy(B.block_table(
        comp.numpy(), off[i:k] - lo, csz[i:k], usz[i:k])).pin_memory()
    out = torch.empty(max(int(usz[i:k].sum()), 1), dtype=torch.uint8,
                      pin_memory=True)
    status = torch.empty(k - i, dtype=torch.int32, pin_memory=True)
    return comp, table, out, status


def on(name, bufs, dev):
    """The buffers a variant takes: copies on the card for kernel@card."""
    if name != "kernel@card":
        return bufs
    return tuple(t.to(dev) for t in bufs)


def run_bam(bam, launch, dev):
    """Every variant of `launch` (name -> launcher) over bam's segments, in
    turns; returns the BAM's record (see the module's docstring)."""
    from ..io import native
    mm, off, csz, usz, segments = segments_of(bam)
    names = list(launch)
    # warm up: each variant's first launch loads its kernel
    i, k = segments[0]
    bufs = staged(mm, off, csz, usz, i, min(k, i + 64))
    for name in names:
        launch[name](*on(name, bufs, dev), dev)
    torch.cuda.synchronize()
    turns = {name: [] for name in names}
    kinds, total = [], 0
    for i, k in segments:
        want = native.bgzf_inflate_blocks(mm, off[i:k], csz[i:k], usz[i:k])
        kinds.append(kind(want.tobytes()))
        total += want.size
        bufs = staged(mm, off, csz, usz, i, k)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            comp, table, out, status = on(name, bufs, dev)
            out.zero_()
            status.fill_(-1)
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            launch[name](comp, table, out, status, dev)
            b.record()
            b.synchronize()
            if status.cpu().numpy().any() or not np.array_equal(
                    out.cpu().numpy()[:want.size], want):
                raise SystemExit(f"inflate_ab: {name} differs from "
                                 f"ct_bgzf_inflate on {bam} blocks {i}-{k}")
            times[name].append(a.elapsed_time(b))
        for name in names:
            turns[name].append(times[name])
    record = {"bam": bam, "segments": len(segments), "bytes": total,
              "kinds": kinds, "variants": {}}
    for name in names:
        ms = [float(np.mean(t)) for t in turns[name]]
        by_kind = {}
        for kd in sorted(set(kinds)):
            sel = [m for m, x in zip(ms, kinds) if x == kd]
            by_kind[kd] = {"segments": len(sel), "ms": sum(sel),
                           "min_ms": min(sel), "max_ms": max(sel)}
        record["variants"][name] = {
            "ms": sum(ms), "segment_ms": ms, "turns_ms": turns[name],
            "gb_per_s": total / sum(ms) / 1e6, "by_kind": by_kind}
    return record


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("bams", nargs="+")
    p.add_argument("--other", action="append", default=[],
                   metavar="NAME=PATH",
                   help="another source of the kernel, such as a parent "
                        "checkout's csrc/bgzf_inflate.cu")
    p.add_argument("--variants", default=None,
                   help="comma-separated names (default: the others, then "
                        "kernel)")
    args = p.parse_args(argv)
    others = dict(o.split("=", 1) for o in args.other)
    if not torch.cuda.is_available():
        print("inflate_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    names = (args.variants.split(",") if args.variants else
             [*others, "kernel"])
    unknown = set(names) - set(others) - {"kernel", "kernel@card"}
    if unknown:
        p.error(f"no source for {sorted(unknown)}: give --other NAME=PATH")
    dev = torch.device("cuda", torch.cuda.current_device())
    launch = launchers(names, others)
    records = []
    for bam in args.bams:
        records.append(run_bam(bam, launch, dev))
        print(json.dumps(records[-1]), flush=True)
    print(result_line(dev, bams=[
        {"bam": r["bam"], **{n: r["variants"][n]["ms"] for n in names}}
        for r in records]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
