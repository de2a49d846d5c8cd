"""The port's boundary: coverm_tpu_torch, its benchmark (bench_torch/) and
chip_smoke.py import neither jax nor the JAX package, and without a card
the port raises unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from coverm_tpu_torch import device as D
from coverm_tpu_torch.io import bgzf
from coverm_tpu_torch.io.sam import sam_text_to_bam_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "coverm_tpu_torch")
BENCH = os.path.join(REPO, "bench_torch")


def _forbidden(module: str) -> bool:
    # coverm_tpu_torch itself starts with "coverm_tpu": match whole names
    return any(module == m or module.startswith(m + ".")
               for m in ("jax", "jaxlib", "coverm_tpu"))


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for top in (PKG, BENCH):
        for root, _, files in os.walk(top):
            out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_forbidden_prefix_guard():
    assert _forbidden("coverm_tpu") and _forbidden("coverm_tpu.ops.sweep")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("coverm_tpu_torch")
    assert not _forbidden("coverm_tpu_torch.ops.sweep")
    assert not _forbidden("jaxtyping_like")


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    sources = _sources()
    assert len(sources) > 20
    parallel = {os.path.basename(p) for p in sources
                if os.path.basename(os.path.dirname(p)) == "parallel"}
    assert {"mesh_sweep.py", "distributed.py", "mesh.py"} <= parallel
    bench = {os.path.basename(p) for p in sources
             if os.path.dirname(p) == BENCH}
    assert {"run.py", "synth.py", "oracle.py", "trace.py"} <= bench
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_the_tools_are_inside_the_boundary():
    """coverm_tpu_torch/scripts/ is a subpackage, so the walk above covers
    the four tools."""
    tools = {os.path.basename(p) for p in _sources()
             if os.path.dirname(p) == os.path.join(PKG, "scripts")}
    assert {"__init__.py", "profile_ingest.py", "validate.py",
            "scaling_bench.py", "dp_ab_bench.py"} <= tools


TOOL_CHECK = """
import sys
from coverm_tpu_torch.scripts import {tool}
rc = {tool}.main(sys.argv[1:])
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "coverm_tpu")
             or m.startswith(("jax.", "jaxlib.", "coverm_tpu.")))
print("RC", rc, "LOADED", bad)
"""


@pytest.mark.parametrize("tool,args", [
    ("validate", ["{bam}"]),
    ("profile_ingest", ["{bam}", "--reps", "1"]),
    ("dp_ab_bench", ["--blocks", "2000", "--reps", "1"])])
def test_tool_runs_load_no_jax(tmp_path, tool, args):
    bam = _bam(str(tmp_path / "x.bam"))
    proc = subprocess.run(
        [sys.executable, "-c", TOOL_CHECK.format(tool=tool),
         *(a.format(bam=bam) for a in args), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=_env(COVERM_TPU_TORCH_CPU_DEVICES="2"))
    assert proc.returncode == 0, proc.stderr
    assert "RC 0 LOADED []" in proc.stdout, proc.stdout + proc.stderr


def _bam(path):
    sam = ["@SQ\tSN:c0\tLN:3000", "@SQ\tSN:c1\tLN:2000"]
    for j in range(200):
        sam.append(f"r{j}\t0\tc{j // 100}\t{1 + (j % 100) * 17}\t60\t100M"
                   f"\t*\t0\t0\t{'A' * 100}\t*\tNM:i:1")
    with open(path, "wb") as f:
        w = bgzf.BgzfWriter(f)
        w.write(sam_text_to_bam_data(iter(sam)))
        w.close()
    return path


CHECK = """
import sys
from coverm_tpu_torch.cli import main
rc = main(["contig", "-b", sys.argv[1], "-m", "mean", "trimmed_mean",
           "covered_fraction"] + sys.argv[2:])
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "coverm_tpu")
             or m.startswith(("jax.", "jaxlib.", "coverm_tpu.")))
print("RC", rc, "LOADED", bad)
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in (D.ENV_VAR, "COVERM_TPU_STREAM_THRESHOLD")}
    env.update(extra)
    return env


@pytest.mark.parametrize("threshold", ["1", str(1 << 40)])
def test_cli_run_loads_no_jax(tmp_path, threshold):
    bam = _bam(str(tmp_path / "x.bam"))
    proc = subprocess.run(
        [sys.executable, "-c", CHECK, bam], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env=_env(COVERM_TPU_TORCH_DEVICE="cpu",
                 COVERM_TPU_STREAM_THRESHOLD=threshold))
    assert proc.returncode == 0, proc.stderr
    assert "RC 0 LOADED []" in proc.stdout, proc.stdout + proc.stderr
    assert proc.stdout.startswith("Contig\tx Mean")


@pytest.mark.parametrize("route", ["cram", "gff"])
def test_cram_and_gff_runs_load_no_jax(tmp_path, route):
    from coverm_tpu_torch.io.cram import sam_to_cram_bytes
    sam = ["@SQ\tSN:c0\tLN:3000", "@SQ\tSN:c1\tLN:2000"]
    sam += [f"r{j}\t0\tc{j // 100}\t{1 + (j % 100) * 17}\t60\t100M"
            f"\t*\t0\t0\t{'A' * 100}\t*\tNM:i:1" for j in range(200)]
    if route == "cram":
        path, extra = str(tmp_path / "x.cram"), []
        with open(path, "wb") as f:
            f.write(sam_to_cram_bytes(iter(sam), records_per_slice=64))
    else:
        path = _bam(str(tmp_path / "x.bam"))
        gff = tmp_path / "g.gff"
        gff.write_text("c0\tt\tgene\t1\t900\t.\t+\t.\tID=a\n"
                       "c1\tt\tgene\t300\t1200\t.\t+\t.\tID=b\n")
        extra = ["--gff", str(gff)]
    proc = subprocess.run(
        [sys.executable, "-c", CHECK, path, *extra], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=_env(COVERM_TPU_TORCH_DEVICE="cpu"))
    assert proc.returncode == 0, proc.stderr
    assert "RC 0 LOADED []" in proc.stdout, proc.stdout + proc.stderr
    assert proc.stdout.startswith("Gene\tContig\tx Mean" if extra
                                  else "Contig\tx Mean")


def test_two_rank_run_loads_no_jax(tmp_path):
    """Both ranks of a multi-process job (gloo on the CPU, two shards a
    rank) end with neither jax nor the JAX package loaded."""
    from test_torch_multiprocess import communicate_all, rank_cmd
    bam = _bam(str(tmp_path / "x.bam"))
    procs = rank_cmd(lambda r: [sys.executable, "-c", CHECK, bam, "-o",
                                str(tmp_path / f"out{r}.tsv")],
                     2, {}, lambda r: REPO)
    for rc, stdout, err in communicate_all(procs):
        assert rc == 0, err
        assert b"RC 0 LOADED []" in stdout, stdout.decode() + err
        assert "engine: contig-sharded over 4 shard(s) of 2 process(es)" \
            in err
    assert (tmp_path / "out0.tsv").read_text().startswith("Contig\tx Mean")
    assert not (tmp_path / "out1.tsv").exists()


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    """chip_smoke.py copied out of the repo fails: without a card here, and
    without the package on a machine that has one."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=_env())
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.delenv(D.ENV_VAR, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        D.default_device()
    with pytest.raises(RuntimeError):
        D.resolve_device("cuda")
    monkeypatch.setenv(D.ENV_VAR, "cpu")
    assert D.default_device() == torch.device("cpu")
    monkeypatch.setenv(D.ENV_VAR, "tpu")
    with pytest.raises(ValueError):
        D.default_device()


def test_local_devices(monkeypatch):
    """Logical CPU devices only when the CPU was asked for; without a
    card and without that request, local_devices raises as
    default_device does. XLA_FLAGS is never read."""
    monkeypatch.setenv(D.ENV_VAR, "cpu")
    monkeypatch.delenv(D.CPU_DEVICES_VAR, raising=False)
    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=8")
    assert D.local_devices() == [torch.device("cpu")]
    monkeypatch.setenv(D.CPU_DEVICES_VAR, "3")
    assert D.local_devices() == [torch.device("cpu")] * 3
    assert D.local_devices("cpu") == [torch.device("cpu")] * 3
    monkeypatch.setenv(D.CPU_DEVICES_VAR, "0")
    with pytest.raises(ValueError):
        D.local_devices()
    monkeypatch.delenv(D.ENV_VAR)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        D.local_devices()


def test_local_devices_of_the_cards(monkeypatch):
    """Every card by default; a device that names a card gives that card
    alone, so a caller's `cuda:1` scans on cuda:1 and nowhere else. The
    card count is faked: nothing here touches a card."""
    monkeypatch.delenv(D.ENV_VAR, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    every = [torch.device("cuda", i) for i in range(4)]
    assert D.local_devices() == every
    assert D.local_devices("cuda") == every
    assert D.local_devices("cuda:3") == [torch.device("cuda", 3)]
    assert D.device_grid(dp=2) == [every[:2], every[2:]]
    assert D.device_grid(devices=["cuda:1"] * 4) == [["cuda:1"] * 4]


def test_cli_without_a_card_exits_with_an_error(tmp_path):
    bam = _bam(str(tmp_path / "x.bam"))
    proc = subprocess.run(
        [sys.executable, "-m", "coverm_tpu_torch", "contig", "-b", bam,
         "-m", "mean"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=_env(CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 1
    assert proc.stdout == ""
    assert "Error: coverm_tpu_torch needs a CUDA device" in proc.stderr


@pytest.mark.parametrize("argv", [
    ["filter", "-b", "{bam}", "-o", "out.bam"],
    ["cluster", "-f", "{bam}"],
    ["makedb", "-r", "ref.fna", "-o", "db"],
    ["contig", "-b", "{bam}", "--profile-dir", "p"],
    ["genome", "-f", "{bam}", "-b", "{bam}", "--max-contamination", "5"],
])
def test_routes_of_the_third_slice_match_jax(tmp_path, argv):
    """Routes that once exited as not yet ported: both packages give the
    same exit status, message, standard output and files."""
    from test_torch_cli_parity import outcome, run_both
    bam = _bam(str(tmp_path / "x.bam"))
    argv = [a.format(bam=bam) for a in argv]
    cwds = [tmp_path / "jax", tmp_path / "torch"]
    for c in cwds:
        c.mkdir()
    results = run_both([argv, argv], cwds=cwds)
    want, got = (outcome(r, c, traces=("p",))
                 for r, c in zip(results, cwds))
    assert got == want
    if argv[0] in ("filter", "contig"):
        assert want[0] == 0 and want[3], want
