"""Multi-process execution: torch.distributed and a cross-process sweep.

Port of the JAX package's parallel/distributed.py. The contig-sharded
sweep (parallel/mesh_sweep.py) is independent across contigs and merges
by a sum, so it extends to shards spread over processes unchanged: every
rank routes the same blocks to the GLOBAL shard set, runs only its own
shard columns, and one `all_reduce(SUM)` of the int64 packed vector
merges them. Every rank ends the pass holding the full statistics, the
state the estimator and taker layers expect; only rank 0 writes output.

Start-up is read from the environment, with the JAX package's names:
COVERM_TPU_COORDINATOR (host:port of rank 0), COVERM_TPU_NUM_PROCESSES
and COVERM_TPU_PROCESS_ID, so `python -m coverm_tpu_torch contig ...`
launched once per rank becomes one job:

    COVERM_TPU_COORDINATOR=localhost:29533 COVERM_TPU_NUM_PROCESSES=2 \\
    COVERM_TPU_PROCESS_ID=0 python -m coverm_tpu_torch contig -b x.bam &
    (and the same with COVERM_TPU_PROCESS_ID=1)

The backend is chosen once, before the first collective, and logged:
NCCL when every rank has a card of its own (device_count >= ranks), gloo
on the CPU or when ranks share a card (NCCL refuses two ranks on one
card). Gloo's all-reduce takes CUDA tensors, so the sweep itself stays
on the card either way. A rank's card is cuda:(rank % device_count).
"""

from __future__ import annotations

import atexit
import logging
import os
from functools import partial

import torch
import torch.distributed as dist

from ..device import default_device, device_grid, local_devices

logger = logging.getLogger("coverm_tpu_torch")

_initialized = False


def backend_for(world_size: int, device: torch.device) -> str:
    """nccl when each of world_size ranks has a card of its own, else
    gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def maybe_initialize() -> bool:
    """Initialise torch.distributed from the environment (idempotent).

    Returns True when running as part of a multi-process job. Called
    first thing by cli.main, before any CUDA work: it sets the rank's
    card."""
    global _initialized
    if _initialized:
        return True
    coord = os.environ.get("COVERM_TPU_COORDINATOR")
    if not coord:
        return False
    world = int(os.environ.get("COVERM_TPU_NUM_PROCESSES", "1"))
    rank = int(os.environ.get("COVERM_TPU_PROCESS_ID", "0"))
    device = default_device()
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    backend = backend_for(world, device)
    logger.info("distributed: rank %d of %d over %s at %s (%s)", rank, world,
                backend, coord,
                "CPU" if device.type == "cpu" else
                f"cuda:{rank % torch.cuda.device_count()} of "
                f"{torch.cuda.device_count()} card(s)")
    dist.init_process_group(backend=backend, init_method=f"tcp://{coord}",
                            world_size=world, rank=rank)
    atexit.register(dist.destroy_process_group)
    _initialized = True
    return True


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def suppress_output() -> bool:
    """True on non-zero ranks of a multi-process job: every process ends
    the pass with identical statistics, so only rank 0 writes the TSV (a
    shared -o path must not be written N times)."""
    return _initialized and dist.get_rank() != 0


def make_global_mesh(dp: int = 1):
    """A `[dp][shard]` grid over every rank's local_devices(), in rank
    order; each entry is (rank, device)."""
    mine = [str(d) for d in local_devices()]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return device_grid(dp=dp, devices=[(r, torch.device(d))
                                       for r, devs in enumerate(every)
                                       for d in devs])


def _local_cols(row) -> list[int]:
    """Indices of the shard columns this rank runs."""
    rank = dist.get_rank()
    return [j for j, (r, _) in enumerate(row) if r == rank]


def _all_reduce_sum(t):
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def compute_depth_stats_sweep_multihost(layout, tids, starts, ends,
                                        need_hist: bool = False, trim=None,
                                        mesh=None, deferred: bool = False):
    """Drop-in for compute_depth_stats_sweep over a mesh that spans
    processes. Every rank must call it with the SAME blocks (the input
    lives on a shared filesystem); routing is deterministic, so each rank
    computes the identical global layout and runs only its own shard
    columns, and every rank issues the same all-reduce in the same
    order."""
    from .mesh_sweep import sweep_routed

    row = (make_global_mesh() if mesh is None else mesh)[0]
    devices = [d for _, d in row]
    return sweep_routed(layout, tids, starts, ends, need_hist, trim, devices,
                        deferred, allow_split=False, cols=_local_cols(row),
                        reduce=_all_reduce_sum)


def multihost_depth_fn(mesh=None):
    """A scan_sample-compatible depth_fn bound to a global mesh."""
    if mesh is None:
        mesh = make_global_mesh()
    return partial(compute_depth_stats_sweep_multihost, mesh=mesh)
