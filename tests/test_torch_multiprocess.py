"""The port's multi-process job (coverm_tpu_torch/parallel/distributed.py):
two ranks of `python -m coverm_tpu_torch` over gloo on the CPU, each with
two logical CPU shards (COVERM_TPU_TORCH_CPU_DEVICES=2), so four shards
in all and one all-reduce per engine batch. Rank 0's `-o` file must
equal, byte for byte, the TSV of the JAX package's single-process run;
rank 1 writes nothing. Every TSV goes to a file, never standard output,
and every process runs under its own timeout, so a rank that hangs in a
collective fails the test instead of stalling the suite.
"""

import os
import socket
import subprocess
import sys

import pytest

from test_torch_cli_parity import make_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
STREAMED = {"COVERM_TPU_STREAM_THRESHOLD": "1"}
WHOLE = {"COVERM_TPU_STREAM_THRESHOLD": str(1 << 40)}


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def base_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("COVERM_TPU")}
    env.update(JAX_PLATFORMS="cpu", COVERM_TPU_PLATFORM="cpu",
               COVERM_TPU_TORCH_DEVICE="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    env.update(extra)
    return env


def communicate_all(procs):
    """[(returncode, stdout, stderr)] of every process, each waited for
    under TIMEOUT; all are killed if one overruns."""
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=TIMEOUT)
            out.append((p.returncode, o, e.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def rank_cmd(cmd, n, env_extra, cwd):
    """Popen `cmd(rank)` in directory `cwd(rank)` once per rank of an
    n-rank job."""
    port = free_port()
    return [subprocess.Popen(
        cmd(r), cwd=cwd(r), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=base_env(COVERM_TPU_TORCH_CPU_DEVICES="2",
                     COVERM_TPU_COORDINATOR=f"localhost:{port}",
                     COVERM_TPU_NUM_PROCESSES=str(n),
                     COVERM_TPU_PROCESS_ID=str(r), **env_extra))
        for r in range(n)]


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp")
    return {"a": make_bam(str(d / "a.bam")),
            "b": make_bam(str(d / "b.bam"), n_contigs=9, contig_len=4000,
                          n_reads=5000, seed=8)}


CASES = {
    "contig_whole": (["contig", "-b", "{a}", "{b}", "-m", "mean",
                      "trimmed_mean", "variance", "covered_fraction"], WHOLE),
    "contig_fused_streamed": (["contig", "-b", "{a}", "{b}", "-m", "mean",
                               "trimmed_mean", "variance", "covered_bases"],
                              STREAMED),
    "genome_separator": (["genome", "-s", "~", "-b", "{a}", "{b}", "-m",
                          "relative_abundance", "mean", "trimmed_mean",
                          "covered_fraction"], STREAMED),
    "coverage_histogram": (["contig", "-b", "{b}", "-m",
                            "coverage_histogram"], WHOLE),
}


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_equal_jax_single_process(bams, tmp_path, case):
    argv, route = CASES[case]
    argv = [a.format(**bams) for a in argv]
    for r in range(2):
        (tmp_path / f"r{r}").mkdir()
    procs = rank_cmd(lambda r: [sys.executable, "-m", "coverm_tpu_torch",
                                *argv, "-o", "out.tsv"],
                     2, route, lambda r: tmp_path / f"r{r}")
    jax_out = tmp_path / "jax.tsv"
    procs.append(subprocess.Popen(
        [sys.executable, "-m", "coverm_tpu", *argv, "-o", str(jax_out)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=base_env(**route)))
    results = communicate_all(procs)
    for rc, _, err in results:
        assert rc == 0, err
    want = jax_out.read_bytes()
    assert want.count(b"\n") >= 2
    assert (tmp_path / "r0" / "out.tsv").read_bytes() == want
    assert os.listdir(tmp_path / "r1") == []  # rank 1 writes nothing
    for r, (_, stdout, err) in enumerate(results[:2]):
        assert stdout == b""
        assert f"distributed: rank {r} of 2 over gloo" in err
        assert "engine: contig-sharded over 4 shard(s) of 2 process(es)" \
            in err


STEP = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from test_torch_mesh import positions, samples
from coverm_tpu_torch.parallel import distributed, mesh
assert distributed.maybe_initialize()
lengths = np.array([1000, 2000, 700, 1500, 128, 999])
grid = distributed.make_global_mesh()
n_pos = len(grid[0])
bases, P_total, pos_seg, window, valid = positions(lengths, 10, n_pos)
idx, val, _ = samples(4, lengths, bases, P_total, n_pos, 400, S=1)
got = mesh.sharded_depth_step(idx, val, pos_seg, window, valid,
                              lengths.size + 1, grid)
want = mesh.sharded_depth_step(idx, val, pos_seg, window, valid,
                               lengths.size + 1,
                               mesh.make_mesh(devices=["cpu"] * n_pos))
assert all(np.array_equal(g, w) for g, w in zip(got, want)), (got, want)
print("STEP OK", n_pos, [r for r, _ in grid[0]])
"""


def test_position_sharded_step_over_two_ranks():
    """parallel/mesh.py on a global grid (two ranks, two pieces each):
    the totals and the statistics travel by all-reduce, and every rank
    ends with the one-process result."""
    tests = os.path.dirname(os.path.abspath(__file__))
    procs = rank_cmd(lambda r: [sys.executable, "-c", STEP, tests], 2, {},
                     lambda r: REPO)
    for rc, stdout, err in communicate_all(procs):
        assert rc == 0, err
        assert b"STEP OK 4 [0, 0, 1, 1]" in stdout, stdout.decode() + err


def test_backend_choice(monkeypatch):
    """gloo on the CPU and when ranks would share a card; NCCL only when
    every rank has a card of its own."""
    import torch

    from coverm_tpu_torch.parallel.distributed import backend_for
    assert backend_for(2, torch.device("cpu")) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert backend_for(2, torch.device("cuda")) == "gloo"
    assert backend_for(1, torch.device("cuda")) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert backend_for(2, torch.device("cuda")) == "nccl"
    assert backend_for(5, torch.device("cuda")) == "gloo"


def test_single_process_is_not_a_job(monkeypatch):
    """Without COVERM_TPU_COORDINATOR nothing starts and nothing is
    suppressed."""
    from coverm_tpu_torch.parallel import distributed
    monkeypatch.delenv("COVERM_TPU_COORDINATOR", raising=False)
    assert distributed.maybe_initialize() is False
    assert not distributed.is_multiprocess()
    assert not distributed.suppress_output()
