"""The port's boundary: coverm_tpu_torch and chip_smoke.py import neither
jax nor the JAX package, and without a card the port raises unless the
caller asks for the CPU."""

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


def _forbidden(module: str) -> bool:
    # coverm_tpu_torch itself starts with "coverm_tpu": match whole names
    return any(module == m or module.startswith(m + ".")
               for m in ("jax", "jaxlib", "coverm_tpu"))


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
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
           "covered_fraction"])
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


def test_cli_without_a_card_exits_with_an_error(tmp_path):
    bam = _bam(str(tmp_path / "x.bam"))
    proc = subprocess.run(
        [sys.executable, "-m", "coverm_tpu_torch", "contig", "-b", bam,
         "-m", "mean"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=_env(CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 1
    assert proc.stdout == ""
    assert "Error: coverm_tpu_torch needs a CUDA device" in proc.stderr


@pytest.mark.parametrize("argv,what", [
    (["contig", "-b", "{bam}", "--gff", "x.gff"], "--gff"),
    (["contig", "-b", "{bam}", "--sharded"], "--sharded"),
    (["contig", "-r", "ref.fna", "-1", "r1.fq"],
     "mapping from reads (give -b sorted BAM files)"),
    (["contig", "-b", "{bam}", "--profile-dir", "p"], "--profile-dir"),
    (["make", "-r", "ref.fna", "-1", "r1.fq", "-o", "out"],
     "the make subcommand"),
])
def test_routes_outside_the_slice_exit_clearly(tmp_path, argv, what):
    from coverm_tpu_torch.cli import main
    bam = _bam(str(tmp_path / "x.bam"))
    argv = [a.format(bam=bam) for a in argv]
    with pytest.raises(SystemExit) as e:
        main(argv, device="cpu")
    assert str(e.value) == (f"Error: {what} is not yet supported by "
                            "coverm_tpu_torch")
