"""The port's native BAM library under concurrent first use, and the
python route taken without it.

`native.get_lib` builds `libcovermio.so` under an exclusive lock on a
file beside it, and its Makefile moves a finished library into place:
six processes that start together on a copy of the package without the
library must all load it. A build that leaves no library raises with the
compiler's message. With COVERM_TPU_NO_NATIVE=1 the fused stream falls
back to the python reader, whose statistics must equal the native
route's: integer fields exactly, the float identity sums to a relative
1e-12 (another order of addition); seed 0.

`load_jax_native` (the autouse fixture `jax_native`, imported by the
test files that run the JAX package's native route in their own
process) builds the JAX package's library under the same kind of lock
and loads it there before the first comparison.
"""

import fcntl
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from coverm_tpu_torch import scan as T
from coverm_tpu_torch.flags import FlagFilter
from coverm_tpu_torch.io import native
from coverm_tpu_torch.io.fastscan import FusedScanStream, fused_available
from coverm_tpu_torch.ops.depth import ReferenceLayout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE_DIR = os.path.join(REPO, "coverm_tpu", "native")
N_PROCS = 6


def load_jax_native():
    """make the JAX package's native library under an exclusive lock and
    load it in this process. That package's get_lib caches a failed load
    for the life of the process (a load that met another process's
    in-place build), so it is given a few more tries."""
    if os.environ.get("COVERM_TPU_NO_NATIVE"):
        return
    from coverm_tpu.io import native as jnative
    with open(os.path.join(JAX_NATIVE_DIR, "libcovermio.so.lock"),
              "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", JAX_NATIVE_DIR], capture_output=True,
                       check=True, timeout=600)
        for _ in range(5):
            if jnative.get_lib() is not None:
                return
            jnative._tried = False
            time.sleep(1)
    raise AssertionError("the JAX package's native library did not load")


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    load_jax_native()


def _copy_package(tmp_path):
    dst = tmp_path / "coverm_tpu_torch"
    shutil.copytree(os.path.join(REPO, "coverm_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns(
                        "_build", "__pycache__", "libcovermio.so*"))
    assert not (dst / "native" / "libcovermio.so").exists()
    return dst


LOAD = """
import sys
from coverm_tpu_torch.io import native
from coverm_tpu_torch.io.fastscan import fused_available
assert native.__file__.startswith(sys.argv[1]), native.__file__
print("LOADED", native.get_lib() is not None and fused_available())
"""


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "COVERM_TPU_NO_NATIVE")}
    env["COVERM_TPU_TORCH_DEVICE"] = "cpu"
    return env


def test_six_concurrent_first_loads_all_succeed(tmp_path):
    pkg = _copy_package(tmp_path)
    procs = [subprocess.Popen([sys.executable, "-c", LOAD, str(tmp_path)],
                              cwd=tmp_path, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for _ in range(N_PROCS)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "LOADED True", out + err
    assert (pkg / "native" / "libcovermio.so").exists()
    assert not [f for f in os.listdir(pkg / "native") if f.endswith(".tmp")]


def test_failed_build_raises_with_the_compilers_message(tmp_path):
    pkg = _copy_package(tmp_path)
    with open(pkg / "native" / "bamdecode.cpp", "a") as f:
        f.write("\n#error deliberately broken source\n")
    proc = subprocess.run([sys.executable, "-c", LOAD, str(tmp_path)],
                          cwd=tmp_path, env=_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr
    assert "deliberately broken source" in proc.stderr
    assert "COVERM_TPU_NO_NATIVE=1" in proc.stderr
    assert not (pkg / "native" / "libcovermio.so").exists()


def test_no_native_returns_none(monkeypatch):
    assert native.get_lib() is not None
    monkeypatch.setenv("COVERM_TPU_NO_NATIVE", "1")
    assert native.get_lib() is None
    assert not fused_available()


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    from test_torch_scan import write_bam
    return write_bam(str(tmp_path_factory.mktemp("native") / "s.bam"))


@pytest.mark.parametrize("need_hist", [False, True])
def test_no_native_fallback_equals_native_route(bam, monkeypatch, need_hist):
    from test_torch_scan import DEPTH_FIELDS, EE, INT_FIELDS, SEG, TRIM

    def scan():
        s = FusedScanStream(bam, target_bytes=SEG)
        h = s.open()
        return T.scan_any(h, s, ReferenceLayout.build(h.target_lens, EE),
                          FlagFilter(), need_hist, trim=TRIM, device="cpu")

    assert fused_available()
    want = scan()
    monkeypatch.setenv("COVERM_TPU_NO_NATIVE", "1")
    got = scan()
    assert got.header.target_names == want.header.target_names
    np.testing.assert_array_equal(got.header.target_lens,
                                  want.header.target_lens)
    for f in INT_FIELDS:
        if f.startswith("identity_sum"):
            # float sums of per-read identities, added in another order by
            # the C++ scan than by numpy
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-12, err_msg=f)
        else:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
    for f in DEPTH_FIELDS:
        np.testing.assert_array_equal(getattr(got.depth, f),
                                      getattr(want.depth, f), err_msg=f)
