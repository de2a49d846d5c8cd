"""The post-sort sweep scan: a hand-written CUDA kernel and its plain version.

Counterpart of the JAX package's ops/pallas_sweep.py (`pallas_sweep_scan`,
the Pallas TPU kernel `_sweep_kernel`) together with the scans that
`ops/sweep.py::_sweep_core` runs after it: the cummax fills of the
window maximum and minimum, the four int64 cumsums and the per-contig
boundary differences. The kernel source is csrc/sweep_scan.cu; it is
compiled with nvcc for sm_90a into a shared library with a plain C
interface on first use (ops/cuda_build.py) and bound with ctypes.

Input: the sorted int64 event keys of `sweep.sort_events`,

    key = seg << 34 | (pos + 1) << 2 | is_start << 1

where each segment's sentinel (pos == -1) sorts first in its segment and
padding (INT64_MAX) sorts last, and `len_tab`, int32[n_seg + 1]: the
segment lengths with a trailing 0 for padding. Outputs:

  depth      int32[E]   running depth: the sum of the signs since the
                        last sentinel at or before the event
  w_len_all  int32[E]   window gap length over [ee, len - ee), unmasked
                        (depth-0 gaps hold the lowest ranks of the
                        trimmed mean)
  seg        int32[E]   segment of the event, n_seg for padding
  per_seg    int64[6, n_seg], in the packed vector's order:
             sum_w   Σ depth · w_len over covered gaps
             cov_w   Σ w_len over covered gaps
             cov_f   Σ full_len (gap length over [0, len)) over covered gaps
             max_w   max depth over covered window gaps, else 0
             sq_w    Σ depth² · w_len over covered gaps
             minpay  max(2³¹ - depth) over window gaps (depth 0
                     included), else 0; min_w = 2³¹ - minpay where > 0

"covered" is depth > 0. Every statistic is an integer sum or maximum, so
the result is exact in any order.

`sweep_scan` takes the kernel for CUDA tensors and the plain version,
`sweep_scan_reference`, for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

PAD_POS = 1 << 30  # position marking padding events
PAD_KEY = (1 << 63) - 1  # key of a padding event
BIGM = 1 << 31  # the window-minimum encoding: minpay = BIGM - depth
PER_SEG_ROWS = ("sum_w", "cov_w", "cov_f", "max_w", "sq_w", "minpay")
_MAX_ROWS = (3, 5)  # rows of per_seg reduced by max; the others by sum
_MASK32 = (1 << 32) - 1

SOURCE = cuda_build.SOURCES[0]  # csrc/sweep_scan.cu
BUILD_DIR = cuda_build.BUILD_DIR

# launches of the CUDA kernel (the plain version does not count); threads
# that launch at once (sample-DP workers, shards) count under _count_lock
sweep_scan_launches = 0

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def build() -> str:
    """Compile this kernel's library where it is missing; returns its
    path (cuda_build.build_all builds every kernel)."""
    return cuda_build.build(SOURCE)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(cuda_build.build(SOURCE))
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.sweep_scan_scratch_words.restype = i64
            lib.sweep_scan_scratch_words.argtypes = [i64, i32]
            lib.sweep_scan_launch.restype = i32
            lib.sweep_scan_launch.argtypes = [vp] * 6 + [i64, i32, i32, i32,
                                                         i32, vp]
            _lib = lib
    return _lib


def _check(key_s, len_tab, n_seg):
    if key_s.dtype != torch.int64 or key_s.dim() != 1 \
            or not key_s.is_contiguous():
        raise ValueError("sweep_scan takes contiguous int64[E] keys")
    if len_tab.dtype != torch.int32 or len_tab.shape != (n_seg + 1,) \
            or not len_tab.is_contiguous() or len_tab.device != key_s.device:
        raise ValueError("sweep_scan takes a contiguous int32[n_seg + 1] "
                         "length table on the keys' device")
    if not 0 <= n_seg < (1 << 31) - 1:
        raise ValueError(f"sweep_scan: n_seg {n_seg} out of range")


def sweep_scan(key_s, len_tab, n_seg, ee):
    """(depth, w_len_all, seg, per_seg) of sorted event keys.

    CUDA tensors go through the kernel, on the current stream of their
    card (named to the launch, whatever card is current); CPU tensors
    through the plain version."""
    global sweep_scan_launches
    n_seg = int(n_seg)
    _check(key_s, len_tab, n_seg)
    if key_s.device.type == "cpu":
        return sweep_scan_reference(key_s, len_tab, n_seg, ee)
    if key_s.device.type != "cuda":
        raise ValueError(f"sweep_scan: unsupported device {key_s.device}")
    dev = key_s.device
    E = key_s.shape[0]
    outs = [torch.empty(E, dtype=torch.int32, device=dev) for _ in range(3)]
    if E == 0:
        return (*outs, torch.zeros(6, n_seg, dtype=torch.int64, device=dev))
    if key_s.data_ptr() % 16:
        raise ValueError("sweep_scan: keys must be 16-byte aligned")
    lib = _load()
    # one zeroed scratch: per_seg first, then the tile ticket and the
    # look-back descriptors
    scratch = torch.empty(int(lib.sweep_scan_scratch_words(E, n_seg)),
                          dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sweep_scan_launch(
        key_s.data_ptr(), len_tab.data_ptr(), *[t.data_ptr() for t in outs],
        scratch.data_ptr(), E, n_seg, int(ee), PAD_POS, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"sweep_scan kernel launch failed on {dev}: "
                           f"CUDA error {err}")
    with _count_lock:
        sweep_scan_launches += 1
    return (*outs, scratch[:6 * n_seg].view(6, n_seg))


def decode_keys(key_s, n_seg):
    """(seg, pos, sign) int32[E] of sorted event keys: padding gets
    (n_seg, PAD_POS, 0), a sentinel pos -1 and sign 0, a start +1 and a
    kept end -1."""
    is_pad = key_s == PAD_KEY
    seg = torch.where(is_pad, n_seg, key_s >> 34).int()
    pos = torch.where(is_pad, PAD_POS, ((key_s >> 2) & _MASK32) - 1).int()
    sign = torch.where(is_pad | (pos == -1), 0,
                       torch.where((key_s & 2) != 0, 1, -1)).int()
    return seg, pos, sign


def sweep_scan_reference(key_s, len_tab, n_seg, ee):
    """Plain PyTorch version of the kernel (same outputs, any device)."""
    ee = int(ee)
    n_seg = int(n_seg)
    dev = key_s.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    seg, pos, sign = decode_keys(key_s, n_seg)
    is_sent = pos == -1

    # depth: the sign scan restarted at each sentinel, i.e. the global
    # cumsum minus its value at the last sentinel at or before the event
    gsign = torch.cumsum(sign, 0, dtype=torch.int32)
    at_sent = gsign[is_sent]
    jump = torch.zeros_like(gsign)
    jump[is_sent] = at_sent - torch.cat([at_sent.new_zeros(1), at_sent[:-1]])
    depth = gsign - torch.cumsum(jump, 0, dtype=torch.int32)

    # gap i covers [pos_i, next_pos_i) within its segment
    length = len_tab[seg.long()]
    next_seg = torch.cat([seg[1:], seg.new_full((1,), n_seg)])
    next_pos = torch.cat([pos[1:], pos.new_full((1,), PAD_POS)])
    gap_end = torch.where(next_seg == seg, next_pos, length)
    full_len = (torch.minimum(gap_end, length)
                - torch.clamp(pos, min=0)).clamp(min=0)
    w_len = (torch.minimum(gap_end, length - ee)
             - torch.clamp(pos, min=ee)).clamp(min=0)
    w_len = torch.where(length > 2 * ee, w_len, zero)
    is_pad = pos >= PAD_POS
    full_len = torch.where(is_pad, zero, full_len)
    w_len = torch.where(is_pad, zero, w_len)

    covered = depth > 0
    d64 = depth.long()
    w_cov = torch.where(covered, w_len, zero).long()
    rows = (d64 * w_cov,
            w_cov,
            torch.where(covered, full_len, zero).long(),
            torch.where(covered & (w_len > 0), d64, 0),
            d64 * d64 * w_cov,
            torch.where(w_len > 0, BIGM - d64, 0))
    # column n_seg collects the padding events and is dropped
    per_seg = torch.zeros(6, n_seg + 1, dtype=torch.int64, device=dev)
    idx = seg.long()
    for r, v in enumerate(rows):
        if r in _MAX_ROWS:
            per_seg[r].scatter_reduce_(0, idx, v, "amax")
        else:
            per_seg[r].index_add_(0, idx, v)
    return depth, w_len, seg, per_seg[:, :n_seg].contiguous()
