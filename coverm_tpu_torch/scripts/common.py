"""What the tools share: the device switch, the last JSON line and the
A/B tools' runs in turns."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch


def add_device_arg(parser):
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default=None,
        help="run on the card (default) or, when asked, on the CPU; "
             "COVERM_TPU_TORCH_DEVICE=cpu asks for it too")


def result_line(dev: torch.device, **fields) -> str:
    """The tool's last line: its fields, the device, the card's name and
    power limit as nvidia-smi prints them (None on the CPU) and the
    host's CPU count, since most of these numbers are the host's."""
    from ..timing import card_line
    return json.dumps({**fields, "device": str(dev),
                       "card": card_line() if dev.type == "cuda" else None,
                       "cpu_count": os.cpu_count()})


def runs_in_turns(script, trees, args):
    """Run `script --child *args` once for each version in turns (NAME,
    this, this, NAME for each NAME of `trees`, {name: checkout}; "this"
    the checkout that holds the script), each in a process of its own
    that imports that checkout's package (PYTHONPATH) from its root, and
    print each child's last line (a JSON object) with its version.
    Returns the objects, or None when a child fails (its stderr
    printed)."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(script))))
    order = list(trees) + ["this", "this"] + list(reversed(trees))
    trees = {**trees, "this": here}
    runs = []
    for name in order:
        root = os.path.abspath(trees[name])
        proc = subprocess.run(
            [sys.executable, os.path.abspath(script), *args, "--child"],
            env=dict(os.environ, PYTHONPATH=root), capture_output=True,
            text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return None
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        got["version"] = name
        runs.append(got)
        print(json.dumps(got), flush=True)
    return runs
