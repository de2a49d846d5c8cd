"""Timing on the card for the measuring scripts (chip_smoke.py,
`python -m coverm_tpu_torch.breakdown`)."""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def event_ms(fn, reps):
    """Median milliseconds of fn() over reps calls, each between two CUDA
    events: the card's time plus any wait for the host to enqueue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def queued_ms(fn, reps, spin_cycles=20_000_000):
    """Device milliseconds per fn(), with all reps calls queued before the
    card reaches them: a spin kernel holds the stream while the host
    enqueues, so the two events time the card's work back to back, not
    the host's launch gaps. fn must not synchronise. The spin is doubled
    until it outlasts the enqueueing."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    while True:
        s = torch.cuda.Event(enable_timing=True)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(spin_cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        torch.cuda.synchronize()
        if s.elapsed_time(a) > host_ms:
            return a.elapsed_time(b) / reps
        spin_cycles *= 2
