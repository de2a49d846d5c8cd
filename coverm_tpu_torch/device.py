"""Device selection for the port.

Entry points run on the card. The CPU is used only when the caller asks
for it, by passing `device="cpu"` to a library function or by setting
`COVERM_TPU_TORCH_DEVICE=cpu` (the counterpart of the JAX package's
`COVERM_TPU_PLATFORM`). Without a card and without that request the
package raises: it never runs on the CPU quietly.

The multi-device engines (parallel/, modes._scanned) take their devices
from `local_devices()`: every card, or, when the CPU was asked for,
`COVERM_TPU_TORCH_CPU_DEVICES` (default 1) logical CPU devices. That
variable is the counterpart of XLA's
`--xla_force_host_platform_device_count`, with which the JAX package's
tests run its mesh on the CPU; it exists so that the multi-device routes
can be tested without cards.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

ENV_VAR = "COVERM_TPU_TORCH_DEVICE"
CPU_DEVICES_VAR = "COVERM_TPU_TORCH_CPU_DEVICES"

# the card indices of this rank in a multi-process job, set by
# parallel.distributed.maybe_initialize (card_share)
job_cards: list[int] | None = None

# card_turn's locks, by card index
_turns: dict[int, threading.Lock] = {}
_turns_lock = threading.Lock()


def default_device() -> torch.device:
    """`cuda`, or `cpu` when COVERM_TPU_TORCH_DEVICE=cpu is set."""
    want = os.environ.get(ENV_VAR, "").strip().lower()
    if want == "cpu":
        return torch.device("cpu")
    if want not in ("", "cuda"):
        raise ValueError(f"{ENV_VAR} must be 'cuda' or 'cpu', not {want!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "coverm_tpu_torch needs a CUDA device and none is available; "
            f"set {ENV_VAR}=cpu to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """An explicit device argument, or default_device() when None."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "coverm_tpu_torch was asked for a CUDA device and none is "
            "available")
    return device


def card_share(hosts: list, rank: int, count: int) -> list[int]:
    """The cards of `rank` in a multi-process job whose ranks run on the
    hosts `hosts` (one name a rank), each host with `count` cards: an
    even share of its host's cards among the ranks there, all of them
    when it is alone, as a JAX process puts all of its local devices in
    the global mesh. The i-th of n ranks on a host takes cards i, i + n,
    i + 2n, ...: its first card is the one it took before the share was
    known. When a host's ranks outnumber its cards, each takes one,
    card i % count, shared."""
    local = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    i, n = local.index(rank), len(local)
    if n > count:
        return [i % count]
    return [i + k * n for k in range(count // n)]


def local_devices(device=None) -> list[torch.device]:
    """The devices this process runs shards on, of the type of
    resolve_device(device): every card, or only the card `device` names
    when it names one (`cuda:1`), or in a multi-process job the rank's
    share of its host's cards (card_share); on the CPU,
    COVERM_TPU_TORCH_CPU_DEVICES copies of `cpu`."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        n = int(os.environ.get(CPU_DEVICES_VAR, "1"))
        if n < 1:
            raise ValueError(f"{CPU_DEVICES_VAR} must be at least 1, not {n}")
        return [torch.device("cpu")] * n
    if dev.type != "cuda":
        raise ValueError(f"no local devices of type {dev.type}")
    count = torch.cuda.device_count()
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        cards = job_cards or [torch.distributed.get_rank() % count]
        return [torch.device("cuda", c) for c in cards]
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(count)]


def device_grid(n_devices: int | None = None, dp: int = 1, devices=None):
    """A `[dp][n]` grid, plain lists, over the first n_devices of
    `devices` (default: local_devices()); they must split into dp equal
    rows. The multi-device engines' meshes (parallel/) are such grids."""
    devices = list(local_devices() if devices is None else devices)
    devices = devices[: n_devices or len(devices)]
    n = len(devices) // dp
    if n < 1 or n * dp != len(devices):
        raise ValueError(f"{len(devices)} devices do not make {dp} dp rows")
    return [devices[r * n:(r + 1) * n] for r in range(dp)]


def card_turn(device=None):
    """The turn on a card (resolve_device(device)) that the ingest on it
    and the engine's dispatch to it take: one lock a card for the whole
    process, so that an ingest's card slot and buffers (io/bam's card
    route, io/fastscan.scan_sample_fused's) are never live during an
    engine call. A context that does nothing for the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return contextlib.nullcontext()
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    with _turns_lock:
        return _turns.setdefault(index, threading.Lock())
