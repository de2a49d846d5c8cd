"""What the tools share: the device switch and the last JSON line."""

from __future__ import annotations

import json
import os

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
