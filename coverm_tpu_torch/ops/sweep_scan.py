"""The post-sort sweep scan: a hand-written CUDA kernel and its plain version.

Counterpart of the JAX package's ops/pallas_sweep.py (`pallas_sweep_scan`,
the Pallas TPU kernel `_sweep_kernel`). The kernel source is
csrc/sweep_scan.cu; it is compiled with nvcc for sm_90a into a shared
library with a plain C interface on first use and bound with ctypes.

Inputs: six int32[E] event arrays sorted by (seg, pos): `seg, pos, sign,
paylen, next_seg, next_pos`. Each contig's sentinel (pos == -1) comes
first in the contig and carries its length in `paylen`; padding events
have pos >= PAD_POS. Outputs, six int32[E]:

  depth      running depth (sign scan minus the per-contig carry)
  w_len      window gap length over [ee, len - ee), masked to depth > 0
  full_len   gap length over [0, len), masked to depth > 0
  max_seg,   running (seg, window-max depth) fill
  max_val
  w_len_all  window gap length, unmasked (depth-0 gaps hold the lowest
             ranks of the trimmed mean and set the window minimum)

`sweep_scan` takes the kernel for CUDA tensors and the plain version,
`sweep_scan_reference`, for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

PAD_POS = 1 << 30  # position marking padding events
N_OUT = 6

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "sweep_scan.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches of the CUDA kernel (the plain version does not count)
sweep_scan_launches = 0

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the sweep-scan kernel needs the "
                           "CUDA toolkit (set CUDA_HOME)")
    return found


def library_path() -> str:
    """Build output for the current source (content-addressed)."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libsweep_scan_{digest.hexdigest()[:12]}.so")


def build_command(out: str) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-o", out, SOURCE]


def build() -> str:
    """Compile the kernel if its library is missing; returns its path.
    The compiler's report (registers, spills) is kept beside it as
    `<library>.log`."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, i64 = ctypes.c_void_p, ctypes.c_longlong
            lib.sweep_scan_scratch_ints.restype = i64
            lib.sweep_scan_scratch_ints.argtypes = [i64]
            lib.sweep_scan_launch.restype = ctypes.c_int
            lib.sweep_scan_launch.argtypes = (
                [vp] * 13 + [i64, ctypes.c_int, ctypes.c_int, vp])
            _lib = lib
    return _lib


def _check(arrays):
    E = arrays[0].shape[0]
    for a in arrays:
        if a.dtype != torch.int32 or a.dim() != 1 or a.shape[0] != E \
                or not a.is_contiguous() or a.device != arrays[0].device:
            raise ValueError("sweep_scan takes six contiguous int32[E] "
                             "tensors on one device")
    return E


def sweep_scan(seg, pos, sign, paylen, next_seg, next_pos, ee):
    """(depth, w_len, full_len, max_seg, max_val, w_len_all), int32[E].

    CUDA tensors go through the kernel; CPU tensors through the plain
    version."""
    global sweep_scan_launches
    ins = (seg, pos, sign, paylen, next_seg, next_pos)
    E = _check(ins)
    if seg.device.type == "cpu":
        return sweep_scan_reference(*ins, ee)
    if seg.device.type != "cuda":
        raise ValueError(f"sweep_scan: unsupported device {seg.device}")
    lib = _load()
    outs = [torch.empty(E, dtype=torch.int32, device=seg.device)
            for _ in range(N_OUT)]
    if E == 0:
        return tuple(outs)
    scratch = torch.empty(int(lib.sweep_scan_scratch_ints(E)),
                          dtype=torch.int32, device=seg.device)
    stream = torch.cuda.current_stream(seg.device).cuda_stream
    err = lib.sweep_scan_launch(
        *[t.data_ptr() for t in ins], *[t.data_ptr() for t in outs],
        scratch.data_ptr(), E, int(ee), PAD_POS, stream)
    if err != 0:
        raise RuntimeError(f"sweep_scan kernel launch failed: CUDA error {err}")
    sweep_scan_launches += 1
    return tuple(outs)


_I32_MIN = -(1 << 31)
_LO32 = (1 << 32) - 1


def _lexmax_fill(seg, value):
    """Inclusive lexicographic (seg, value) max-scan from the initial pair
    (-1, 0), as the TPU kernel's forward fills; returns (seg, value)."""
    key = (seg.long() << 32) + (value.long() - _I32_MIN)
    init = torch.tensor([(-1 << 32) - _I32_MIN], dtype=torch.int64,
                        device=seg.device)
    run = torch.cummax(torch.cat([init, key]), 0).values[1:]
    return ((run >> 32).int(), ((run & _LO32) + _I32_MIN).int())


def sweep_scan_reference(seg, pos, sign, paylen, next_seg, next_pos, ee):
    """Plain PyTorch version of the kernel (same outputs, any device)."""
    ee = int(ee)
    zero = torch.zeros((), dtype=torch.int32, device=seg.device)
    gsign = torch.cumsum(sign, 0, dtype=torch.int32)
    is_sent = pos == -1
    length = _lexmax_fill(seg, torch.where(is_sent, paylen, zero))[1]
    carry = _lexmax_fill(seg, torch.where(is_sent, gsign, zero))[1]
    depth = gsign - carry
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
    max_seg, max_val = _lexmax_fill(
        seg, torch.where(covered & (w_len > 0), depth, zero))
    return (depth, torch.where(covered, w_len, zero),
            torch.where(covered, full_len, zero), max_seg, max_val, w_len)
