"""CLI parity on the multi-device routes: `python -m coverm_tpu_torch`
with eight logical CPU devices (COVERM_TPU_TORCH_CPU_DEVICES=8) against
`python -m coverm_tpu` on eight virtual XLA devices, over two samples.

Under COVERM_TPU_MESH=auto two samples scan concurrently on two device
groups of four, each contig-sharded over its group (sample-DP), and both
packages log the same `engine: sample-DP over 2 device group(s) of [4, 4]`
line; a single sample takes the contig-sharded mesh over all eight.
Under COVERM_TPU_MESH=1 every sample takes the mesh. Standard output must
be byte-equal, on the whole-file route and on the fused streaming route.

The JAX package's native loader lets a second thread that asks while the
first is still loading fall back to the pure-Python header parse, which
fails on its numpy buffer; so the JAX side loads its library before the
sample-DP threads start (JAX_FIRST). The port's loader waits on its lock.
"""

import os
import re
import subprocess
import sys

import pytest

from test_torch_cli_parity import REPO, STREAMED, WHOLE, make_bam
from test_torch_native_build import jax_native  # noqa: F401

JAX_FIRST = ("import sys; from coverm_tpu.io import native; "
             "native.get_lib(); from coverm_tpu.cli import main; "
             "sys.exit(main())")

EIGHT = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
         "COVERM_TPU_TORCH_CPU_DEVICES": "8"}
SAMPLE_DP = "engine: sample-DP over 2 device group(s) of [4, 4] " \
    "(contig-sharded within each group)"


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("routes")
    return {"a": make_bam(str(d / "a.bam")),
            "b": make_bam(str(d / "b.bam"), n_contigs=9, contig_len=4000,
                          n_reads=5000, seed=8)}


CASES = {
    "contig_auto_whole": (["contig", "-b", "{a}", "{b}", "-m", "mean",
                           "trimmed_mean", "variance", "covered_fraction"],
                          "auto", WHOLE),
    "contig_auto_streamed": (["contig", "-b", "{a}", "{b}", "-m", "mean",
                              "trimmed_mean", "covered_bases", "rpkm"],
                             "auto", STREAMED),
    "genome_mesh1_whole": (["genome", "-s", "~", "-b", "{a}", "{b}", "-m",
                            "relative_abundance", "mean", "trimmed_mean",
                            "variance"], "1", WHOLE),
    "contig_mesh1_streamed": (["contig", "-b", "{a}", "{b}", "-m", "mean",
                               "trimmed_mean", "variance"], "1", STREAMED),
    "histogram_one_sample_auto": (["contig", "-b", "{b}", "-m",
                                   "coverage_histogram"], "auto", STREAMED),
}


def run_both(argv, env_extra):
    """The JAX package (its native library loaded first) and the port on
    the CPU side by side; [(returncode, stdout, stderr)] in that order."""
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", COVERM_TPU_PLATFORM="cpu",
               COVERM_TPU_TORCH_DEVICE="cpu", PYTHONPATH=REPO, **env_extra)
    procs = [subprocess.Popen(cmd + argv, cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for cmd in ([sys.executable, "-c", JAX_FIRST],
                         [sys.executable, "-m", "coverm_tpu_torch"])]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        out.append((p.returncode, stdout, stderr.decode()))
    return out


def engine_lines(stderr):
    return [re.sub(r"^\[[^]]*\] ", "", l) for l in stderr.splitlines()
            if "engine: " in l]


@pytest.mark.parametrize("case", list(CASES))
def test_multi_device_routes_byte_equal(bams, case):
    argv, mesh, route = CASES[case]
    argv = [a.format(**bams) for a in argv]
    (rc_j, out_j, err_j), (rc_t, out_t, err_t) = run_both(
        argv, {**route, **EIGHT, "COVERM_TPU_MESH": mesh})
    assert rc_j == 0, err_j
    assert rc_t == 0, err_t
    assert out_j.count(b"\n") >= 2
    assert out_t == out_j
    if mesh == "auto" and bams["a"] in argv:  # two samples
        assert engine_lines(err_j) == [SAMPLE_DP]
        assert engine_lines(err_t) == [SAMPLE_DP]
    else:
        assert engine_lines(err_t) == ["engine: contig-sharded over 8 "
                                       "shard(s)"]
        assert "sample-DP" not in err_j
