"""Builds the port's hand-written CUDA kernels.

Each source under csrc/ is compiled with nvcc for sm_90a into a shared
library with a plain C interface, loaded with ctypes by its wrapper
(ops/sweep_scan.py, ops/bgzf_inflate.py, ops/bam_scan.py). A library is content-addressed
by its source and the flags, written under a temporary name and moved
into place, and the compiler's `-Xptxas -v` report (registers, spills)
is kept beside it as `<library>.log`. `build_all` builds every kernel,
one nvcc a source, all started together, so that whoever builds one
kernel before a timed run builds them all.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = [os.path.join(_PKG, "csrc", name)
           for name in ("sweep_scan.cu", "bgzf_inflate.cu", "bam_scan.cu")]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the record scan's float32 filter quotients must round as numpy's do: no
# fast math, IEEE division, denormals kept, no fused multiply-adds
EXTRA_FLAGS = {SOURCES[2]: ["-prec-div=true", "-ftz=false", "-fmad=false"]}


def flags(source: str) -> list[str]:
    """nvcc's flags for `source`."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(source, [])


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return found


def library_path(source: str) -> str:
    """Build output for the current source (content-addressed)."""
    with open(source, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(flags(source)).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:12]}.so")


def build(source: str) -> str:
    """Compile `source` if its library is missing; returns its path."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([_nvcc(), *flags(source), "-o", tmp, source],
                          capture_output=True, text=True)
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> dict[str, str]:
    """Every kernel's library by source, built where missing, one nvcc a
    source, all started together; raises with the first failure."""
    paths, errors = {}, []

    def one(source):
        try:
            paths[source] = build(source)
        except (RuntimeError, OSError) as e:  # re-raised below
            errors.append(e)
    threads = [threading.Thread(target=one, args=(s,)) for s in SOURCES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return paths
