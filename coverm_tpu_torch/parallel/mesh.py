"""Position-sharded depth step over several devices.

Port of the JAX package's parallel/mesh.py, as plain torch (it has no
Pallas kernel). The reference is a single-process tool; its closest
analogues to parallel axes are the serial multi-sample loop
(contig.rs:22) and the `--sharded` reference-sharding merge
(shard_bam_reader.rs). Here both are axes of a `[dp][pos]` grid of
devices:

  - ``dp``  (data parallel): samples go to the grid's rows;
  - ``pos`` (sequence parallel): the padded position axis of a chunk is
    cut into one piece per device of the row — each device adds its
    local deltas (int32 `index_add_`) and runs a local cumsum; the carry
    between pieces is the exclusive scan of the pieces' totals, and the
    per-contig segment totals are summed over pieces so that the
    per-contig carry correction and the final statistics agree with the
    single-device engine bit for bit. The segment maximum is taken after
    the merge.

In one process the collectives are sums over the piece list. On a grid
from parallel.distributed.make_global_mesh (entries (rank, device)) each
rank runs its own pieces and the collectives are all-reduces over the
job. No CLI route reaches this step; the JAX package's users are
__graft_entry__.dryrun_multichip and tests/test_parallel.py.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..device import device_grid

I64_MIN = torch.iinfo(torch.int64).min

# make_mesh(n_devices=None, dp=1, devices=None): a `[dp][pos]` grid
make_mesh = device_grid


def _segment_sum(x, seg, n_seg, dtype):
    out = torch.zeros(n_seg + 1, dtype=dtype, device=x.device)
    out.index_add_(0, seg, x.to(dtype))
    return out[:n_seg]


def _local_scatter(idx, val, pos_seg, n_seg):
    """A piece's deltas (scatter points rebased to local positions,
    points outside [0, local_P] dropped; local_P is the dump slot), their
    local cumsum and the piece's per-segment delta totals."""
    Pl = pos_seg.shape[0]
    keep = (idx >= 0) & (idx <= Pl)
    delta = torch.zeros(Pl + 1, dtype=torch.int32, device=idx.device)
    delta.index_add_(0, idx[keep].long(), val[keep])
    delta = delta[:Pl]
    return (delta, torch.cumsum(delta, 0, dtype=torch.int32),
            _segment_sum(delta, pos_seg, n_seg, torch.int32))


def _local_stats(local_cumsum, offset, carry, pos_seg, window, valid, n_seg):
    """A piece's partial per-segment statistics, given the carry into
    the piece and the job-wide per-segment carry."""
    depth = local_cumsum.long() + offset - carry[pos_seg].int()
    dw = torch.where(window, depth, 0)
    max_w = torch.full((n_seg + 1,), I64_MIN, dtype=torch.int64,
                       device=depth.device)
    max_w.scatter_reduce_(0, pos_seg, dw, "amax")
    return (_segment_sum(dw, pos_seg, n_seg, torch.int64),
            _segment_sum((dw > 0).int(), pos_seg, n_seg, torch.int64),
            _segment_sum((depth > 0) & valid, pos_seg, n_seg, torch.int64),
            max_w[:n_seg])


def _row_step(idx, val, pos_seg, window, valid, n_seg, row):
    """One sample over one grid row; (sum_w, cov_w, cov_f, max_w) on the
    row's first device (the first of this rank's on a global grid)."""
    n_pos = len(row)
    distributed = isinstance(row[0], tuple)
    if distributed:
        me = dist.get_rank()
        cols = [j for j, (r, _) in enumerate(row) if r == me]
        devs = {j: row[j][1] for j in cols}
    else:
        cols = list(range(n_pos))
        devs = dict(enumerate(row))
    Pl = pos_seg.shape[0] // n_pos
    Bl = idx.shape[0] // n_pos
    home = devs[cols[0]]

    def piece(a, j, n):
        return torch.from_numpy(np.ascontiguousarray(a[j * n:(j + 1) * n])) \
            .to(devs[j])

    ins = {j: (piece(idx, j, Bl), piece(val, j, Bl),
               piece(pos_seg, j, Pl).long(), piece(window, j, Pl),
               piece(valid, j, Pl)) for j in cols}
    local = {j: _local_scatter(ins[j][0], ins[j][1], ins[j][2], n_seg)
             for j in cols}

    # the pieces' totals (an all_gather: each rank fills its own) and the
    # per-segment totals (a sum over pieces)
    totals = torch.zeros(n_pos, dtype=torch.int64, device=home)
    seg_total = torch.zeros(n_seg, dtype=torch.int64, device=home)
    for j in cols:
        _, cs, st = local[j]
        if Pl:
            totals[j] = cs[-1].to(home)
        seg_total += st.to(home)
    if distributed:
        dist.all_reduce(totals)
        dist.all_reduce(seg_total)
    offsets = torch.cumsum(totals, 0) - totals
    carry = torch.cumsum(seg_total, 0) - seg_total

    parts = [_local_stats(local[j][1], offsets[j].to(devs[j]),
                          carry.to(devs[j]), ins[j][2], ins[j][3],
                          ins[j][4], n_seg) for j in cols]
    out = [sum(p[k].to(home) for p in parts) for k in range(3)]
    max_w = torch.stack([p[3].to(home) for p in parts]).amax(0)
    if distributed:
        for t in out:
            dist.all_reduce(t)
        dist.all_reduce(max_w, op=dist.ReduceOp.MAX)
    return (*out, max_w)


def sharded_depth_step(idx, val, pos_seg, window, valid, n_seg, mesh):
    """One depth-stats step over a `[dp][pos]` grid.

    Shapes (S = samples, B = scatter points per sample, P = positions),
    numpy arrays:
      idx, val:  int32[S, B]  each row is n_pos equal pieces, one per
                              position shard, of the scatter points the
                              host routed to it (route_scatter_points)
      pos_seg:   int32[P]     cut into n_pos equal pieces
      window, valid: bool[P]
    Sample s runs on row s // (S / dp). Returns per-sample per-contig
    (sum_w, cov_w, cov_f, max_w), int64 numpy arrays [S, n_seg]; max_w
    is INT64_MIN for a segment that owns no position."""
    S, dp = idx.shape[0], len(mesh)
    if S % dp:
        raise ValueError(f"{S} samples do not split over {dp} dp rows")
    pos_seg = np.asarray(pos_seg)
    if pos_seg.size and (pos_seg.min() < 0 or pos_seg.max() >= n_seg):
        raise ValueError(f"pos_seg holds a segment outside [0, {n_seg})")
    rows = [_row_step(idx[s], val[s], pos_seg, window, valid, n_seg,
                      mesh[s // (S // dp)]) for s in range(S)]
    return tuple(np.stack([r[k].cpu().numpy() for r in rows])
                 for k in range(4))


def route_scatter_points(idx, val, P_total, n_pos_shards, pad_to=None):
    """Host-side routing of scatter points to position shards.

    Points are rebased to shard-local coordinates; every shard's list is
    padded to ``pad_to`` (default: the max shard occupancy) with
    dump-slot points (local_P).  Returns int32[n_pos_shards * pad_to]
    arrays laid out so an even cut gives each shard exactly its own
    points.
    """
    Pl = P_total // n_pos_shards
    shard_of = np.minimum(idx // Pl, n_pos_shards - 1)
    # points on the dump slot (idx == P_total) keep dumping
    local = idx - shard_of * Pl
    local = np.where(idx >= P_total, Pl, local)
    out_idx, out_val = [], []
    max_len = 1
    for s in range(n_pos_shards):
        m = shard_of == s
        out_idx.append(local[m])
        out_val.append(val[m])
        max_len = max(max_len, int(m.sum()))
    if pad_to is not None:
        if pad_to < max_len:
            raise ValueError(f"pad_to {pad_to} < max shard occupancy {max_len}")
        max_len = pad_to
    idx_arr = np.full((n_pos_shards, max_len), Pl, dtype=np.int32)
    val_arr = np.zeros((n_pos_shards, max_len), dtype=np.int32)
    for s in range(n_pos_shards):
        k = out_idx[s].size
        idx_arr[s, :k] = out_idx[s]
        val_arr[s, :k] = out_val[s]
    return idx_arr.reshape(-1), val_arr.reshape(-1)
