"""The port's tools (coverm_tpu_torch/scripts/) against the JAX package's
scripts/ and engines, on the CPU.

- validate: on three synth.write_sorted_bam BAMs (4 contigs x 50 kbp at
  20x; 2 contigs x 3 kbp at 600x, deeper than the histogram's 512 bins,
  so its rows overflow to DepthStats.hist_wide; 400 contigs x 300 bp at
  1x, some with no read), over the whole-file and the streamed route,
  `python -m coverm_tpu_torch.scripts.validate` prints on standard output
  exactly what `python scripts/validate.py` prints and exits with the
  same code; with one contig's depth sum one higher it names that contig
  and exits 1.
- profile_ingest: the record, block and byte counts of its stages equal
  the JAX package's parse_records_full, bgzf_inflate_blocks and
  ingest_scan over the whole file, at 1 MB segments and at the default;
  with --cram, over the first BAM's CRAM twin, the slices, records and
  blocks of its sequential and pool passes equal the JAX package's
  direct-stats scan.
- scaling_bench: at 200,000 reads one rank and two gloo ranks give the
  same checksum, equal to the JAX package's compute_depth_stats_sweep on
  the JAX script's build_workload; each rank is pinned to one card.
- dp_ab_bench: at 40,000 blocks a sample on 8 logical CPU devices both
  arms are bit-equal to each other and to the JAX package's
  compute_depth_stats_sweep_mesh on the conftest's 8-device mesh.

Every subprocess runs under TIMEOUT seconds.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from coverm_tpu_torch import device as D
from coverm_tpu_torch.scripts import dp_ab_bench, scaling_bench
from coverm_tpu_torch.scripts import validate as V
from coverm_tpu_torch.synth import write_sorted_bam
from scripts_path import SCRIPTS
from test_torch_native_build import jax_native  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
BAMS = {"flat": dict(n_contigs=4, contig_len=50_000, coverage=20, seed=3),
        "deep": dict(n_contigs=2, contig_len=3000, coverage=600, seed=5),
        "sparse": dict(n_contigs=400, contig_len=300, coverage=1, seed=6)}


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("COVERM_TPU")}
    env.update(JAX_PLATFORMS="cpu", COVERM_TPU_PLATFORM="cpu",
               COVERM_TPU_TORCH_DEVICE="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    env.update(extra)
    return env


def _run(argv, **env):
    return subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=TIMEOUT, env=_env(**env))


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("bams")
    out = {}
    for name, kw in BAMS.items():
        out[name] = str(d / f"{name}.bam")
        out[name + "_tids"] = write_sorted_bam(out[name], **kw)[0]
    return out


@pytest.fixture(scope="module", params=["whole", "streamed"])
def validated(request, bams):
    """(JAX run, port run) of validate over the three BAMs."""
    threshold = "1" if request.param == "streamed" else str(1 << 40)
    paths = [bams[name] for name in BAMS]
    return [_run(argv + paths, COVERM_TPU_STREAM_THRESHOLD=threshold)
            for argv in ([sys.executable,
                          os.path.join(SCRIPTS, "validate.py")],
                         [sys.executable, "-m",
                          "coverm_tpu_torch.scripts.validate"])]


@pytest.mark.parametrize("i", range(len(BAMS)))
def test_validate_prints_as_the_jax_script(validated, i):
    want, got = validated
    assert want.returncode == got.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    assert len(want.stdout.splitlines()) == len(BAMS)
    line = want.stdout.splitlines()[i]
    assert line.startswith(f"{list(BAMS)[i]}.bam: ") and \
        " covered contigs checked, 0 failures (" in line
    res = json.loads(got.stderr.strip().splitlines()[-1])
    assert res["failures"] == 0 and res["card"] is None and res["cpu_count"]


def test_validate_bams_take_the_overflow_and_skip_unread_contigs(bams):
    from coverm_tpu_torch.flags import FlagFilter
    from coverm_tpu_torch.modes import BamFileSource
    from coverm_tpu_torch.ops.depth import ReferenceLayout
    from coverm_tpu_torch.scan import scan_any
    scans = {}
    for name in ("deep", "sparse"):
        header, payload = BamFileSource(bams[name]).read()
        scans[name] = scan_any(header, payload, ReferenceLayout.build(
            header.target_lens, 0), FlagFilter(), need_hist=True,
            device="cpu")
    assert scans["deep"].depth.hist_wide
    assert 0 < scans["sparse"].observed.sum() < BAMS["sparse"]["n_contigs"]


def test_validate_fails_on_a_perturbed_depth(bams, monkeypatch, capsys):
    """The sweep engine, where the whole-file scan calls it, returns one
    contig's depth sum one higher: the validator names that contig and
    returns 1; unperturbed it returns 0, and 2 without a BAM."""
    from coverm_tpu_torch import scan
    orig = scan.compute_depth_stats_sweep
    path = bams["sparse"]
    monkeypatch.setenv(D.ENV_VAR, "cpu")
    assert V.main([path]) == 0
    assert V.main([]) == 2
    capsys.readouterr()
    contig = int(bams["sparse_tids"][-1])

    def engine(layout, tids, *args, **kwargs):
        d = orig(layout, tids, *args, **kwargs)
        d.sum_depth_window[contig] += 1
        return d
    monkeypatch.setattr(scan, "compute_depth_stats_sweep", engine)
    assert V.main([path, "--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"FAIL c{contig}: histogram mean ")
    assert out[1].startswith("sparse.bam: ") and " 1 failures " in out[1]


@pytest.mark.parametrize("tool", ["validate", "profile_ingest",
                                  "scaling_bench", "dp_ab_bench"])
def test_tools_raise_without_a_card(bams, monkeypatch, tool):
    """Without a card and without a request for the CPU each tool raises
    before it does any work; none drops to the CPU."""
    import importlib
    main = importlib.import_module(f"coverm_tpu_torch.scripts.{tool}").main
    monkeypatch.delenv(D.ENV_VAR, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [bams["flat"]] if tool in ("validate", "profile_ingest") else []
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        main(argv)


def _jax_counts(path):
    """(inflated bytes, records, blocks of the full parse, records and
    blocks of ingest_scan) of the JAX package over the whole file."""
    from coverm_tpu.io import native as jn
    from coverm_tpu.io.bam import _parse_header
    mm = np.memmap(path, np.uint8, mode="r")
    off, csz, usz = jn.bgzf_scan(mm)
    data = jn.bgzf_inflate_blocks(mm, off, csz, usz)
    header, start = _parse_header(data)
    full = jn.parse_records_full(data, start, None)
    stats = jn.StatsAccum(len(header.target_names))
    bt, _, _, _, left = jn.ingest_scan(mm, off, csz, usz, None, start, stats,
                                       0x100, 0)
    assert not len(left)
    return (data.size, full["tid"].size, full["block_read"].size,
            stats.n_records, bt.size)


@pytest.mark.parametrize("segment_bytes", ["1000000", None])
def test_profile_ingest_counts_equal_the_jax_package(bams, segment_bytes):
    from coverm_tpu_torch.scripts.profile_ingest import STAGES
    path = bams["flat"]
    extra = {} if segment_bytes is None else {
        "COVERM_TPU_SEGMENT_BYTES": segment_bytes}
    proc = _run([sys.executable, "-m",
                 "coverm_tpu_torch.scripts.profile_ingest", path,
                 "--reps", "1", "--device", "cpu"], **extra)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    st = res["stages"]
    assert list(st) == [k for k, _ in STAGES]
    assert all(v["s"] >= 0 for v in st.values())
    n_bytes, records, blocks, fused_records, fused_blocks = _jax_counts(path)
    assert st["inflate"]["bytes"] == n_bytes
    # the header probe's blocks, then segments of about segment_bytes
    assert st["inflate"]["segments"] == (2 if segment_bytes is None else 8)
    for key in ("phase1", "full_parse", "stats_scan", "bookkeep", "stream",
                "fused", "classic_host"):
        assert st[key]["records"] == records, key
    # the classic reader's host route, stage by stage
    assert set(st["classic_host"]["split_s"]) == {
        "bgzf_scan", "inflate", "walk", "parse", "cat", "concat"}
    assert st["classic_host"]["split_s"]["inflate"] > 0
    assert st["classic_host"]["split_s"]["walk"] > 0
    assert st["full_parse"]["blocks"] == blocks
    assert fused_records == records
    for key in ("stats_scan", "fused", "e2e_stub", "host_scan_split"):
        assert st[key]["blocks"] == fused_blocks, key
    # the card route's host scan as it ran before its scan moved onto the
    # card, timed apart (the scan's own clocks inside stats_scan)
    split = st["host_scan_split"]
    assert split["records"] == records
    assert set(split["stage_s"]) == {"wait", "d2h", "carry", "stats_scan",
                                     "chain_walk", "chunk_workers"}
    assert split["stage_s"]["stats_scan"] > 0
    assert 0 < split["stage_s"]["chain_walk"]
    assert 0 < split["stage_s"]["chunk_workers"]
    assert st["e2e"]["mapped_reads"] == st["e2e_stub"]["mapped_reads"] \
        == fused_blocks
    assert st["e2e"]["k1_launches"] == 0  # the plain version on the CPU
    assert res["prologue_s"]["batches"] >= 1
    assert all(v["peak_rss_bytes"] > 0 for v in st.values())
    assert res["rss_at_start_bytes"] > 0 and res["card"] is None


def test_profile_ingest_reads_the_card_scan_from_its_inflater(
        bams, monkeypatch):
    """The stubbed pass's card split: with the card route stood in for by
    the CPU, profile_ingest records the inflater and the scan of every
    segment it inflates (its records, its regions walked again; no CUDA
    events on the CPU), and they add up to the file's records."""
    from coverm_tpu_torch.io import fastscan
    from coverm_tpu_torch.ops import bgzf_inflate as B
    from coverm_tpu_torch.scripts import profile_ingest as P
    monkeypatch.setenv("COVERM_TPU_SEGMENT_BYTES", "1000000")
    monkeypatch.setattr(
        fastscan, "_card_inflater",
        lambda dev: lambda path, off, csz, usz, segments, at:
        B.SegmentInflater(path, off, csz, usz, segments, at, "cpu"))
    with P.inflaters_made() as made, P.scans_made() as scans:
        mapped, blocks = P.e2e_pass(bams["flat"], torch.device("cpu"),
                                    stub=True)
    assert len(made) == 1
    assert len(scans) == len(made[0].segments) > 1
    assert sum(sc["records"] for sc in scans) == _jax_counts(
        bams["flat"])[3]
    assert all(sc["regions_walked"] >= 0 and sc["ms"] is None
               for sc in scans)
    assert blocks == mapped > 0


def test_profile_ingest_cram_counts_equal_the_jax_package(tmp_path):
    """--cram: the sequential and the pool pass read every slice, record
    and block that the JAX package's direct-stats scan reads, and the
    stubbed pass hands on its blocks."""
    from coverm_tpu.flags import FlagFilter as JFlagFilter
    from coverm_tpu.io import native as jn
    from coverm_tpu.io.fastscan import FusedScanStream as JFused
    from coverm_tpu.io.fastscan import _cram_slice_blocks
    from coverm_tpu_torch.scripts.profile_ingest import CRAM_STAGES
    from coverm_tpu_torch.synth import write_cram_twin

    path = str(tmp_path / "flat.cram")
    write_cram_twin(path, per_slice=500, **BAMS["flat"])
    proc = _run([sys.executable, "-m",
                 "coverm_tpu_torch.scripts.profile_ingest", path, "--cram",
                 "--reps", "1", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    st = res["stages"]
    assert list(st) == ["sequential", "pool", "e2e_stub", "e2e"]
    js = JFused(path)
    jh = js.open()
    stats = jn.StatsAccum(jh.n_ref)
    slices = list(_cram_slice_blocks(js, stats, *JFlagFilter().masks()))
    blocks = sum(s[0].size for s in slices)
    seq, pool = st["sequential"], st["pool"]
    for got in (seq, pool):
        assert got["slices"] == len(slices) > 10
        assert got["records"] == stats.n_records
        assert got["blocks"] == blocks
    assert seq["rejected_slices"] == seq["unmapped_slices"] == 0
    assert list(seq["stage_s"]) == list(pool["stage_thread_s"]) \
        == list(CRAM_STAGES)
    assert all(v > 0 for v in seq["stage_s"].values())
    assert pool["workers"] >= 1
    assert st["e2e_stub"]["blocks"] == blocks
    assert st["e2e"]["mapped_reads"] == st["e2e_stub"]["mapped_reads"]
    assert st["e2e"]["k1_launches"] == 0  # the plain version on the CPU
    assert all(v["peak_rss_bytes"] > 0 and v["s"] > 0 for v in st.values())
    assert res["card"] is None


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scaling_bench_checksum_equals_the_jax_engine():
    from coverm_tpu.ops.depth import ReferenceLayout
    from coverm_tpu.ops.sweep import compute_depth_stats_sweep
    reads = 200_000
    J = _jax_script("scaling_bench")
    work = J.build_workload(reads)
    for a, b in zip(work, scaling_bench.build_workload(reads)):
        np.testing.assert_array_equal(a, b)
    layout = ReferenceLayout.build(
        np.full(J.N_CONTIGS, J.CONTIG_LEN, dtype=np.int64), 75)
    want = int(np.asarray(compute_depth_stats_sweep(
        layout, *work, trim=J.TRIM).sum_depth_window).sum())
    proc = _run([sys.executable, "-m",
                 "coverm_tpu_torch.scripts.scaling_bench", "--nproc", "2",
                 "--reads", str(reads), "--device", "cpu", "--timeout",
                 str(TIMEOUT // 2)])
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(l) for l in proc.stdout.strip().splitlines()]
    one, two, res = lines
    assert one["checksum"] == two["checksum"] == res["checksum"] == want
    assert (one["n_processes"], two["n_processes"]) == (1, 2)
    assert res["transport"] == "gloo" and res["efficiency"] > 0
    assert res["efficiency"] == res["rps_2proc"] / (2 * res["rps_1proc"])


@pytest.mark.parametrize("nproc,n_cards", [(1, 4), (2, 4), (4, 4), (8, 4)])
def test_scaling_ranks_take_one_card_each(nproc, n_cards, monkeypatch):
    """On a faked four-card host each rank of an nproc-rank job takes one
    card of its own while there are enough (the job sees the first nproc
    cards, and device.card_share gives rank r card r), over NCCL; beyond
    that the ranks see every card and card_share gives each one, shared,
    over gloo."""
    from coverm_tpu_torch.parallel.distributed import backend_for
    envs = [scaling_bench.rank_env({"PATH": "/bin"}, r, nproc, 1234,
                                   "cuda", n_cards) for r in range(nproc)]
    for r, env in enumerate(envs):
        assert env["COVERM_TPU_PROCESS_ID"] == str(r)
        assert env["COVERM_TPU_NUM_PROCESSES"] == str(nproc)
        assert env["COVERM_TPU_COORDINATOR"] == "localhost:1234"
    hosts = ["h"] * nproc
    if nproc <= n_cards:
        seen = nproc
        assert all(e["CUDA_VISIBLE_DEVICES"] == ",".join(
            str(c) for c in range(nproc)) for e in envs)
        assert [D.card_share(hosts, r, seen) for r in range(nproc)] == \
            [[r] for r in range(nproc)]
    else:
        seen = n_cards
        assert all("CUDA_VISIBLE_DEVICES" not in e for e in envs)
        assert all(len(D.card_share(hosts, r, seen)) == 1
                   for r in range(nproc))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: seen)
    assert backend_for(nproc, torch.device("cuda")) == \
        ("nccl" if nproc <= n_cards else "gloo")
    visible = scaling_bench.rank_env({"CUDA_VISIBLE_DEVICES": "5,6,7"}, 1,
                                     2, 1, "cuda", 3)
    assert visible["CUDA_VISIBLE_DEVICES"] == "5,6"
    cpu = scaling_bench.rank_env({}, 0, nproc, 1, "cpu", 0, 3)
    assert (cpu["COVERM_TPU_TORCH_CPU_DEVICES"], cpu["OMP_NUM_THREADS"]) \
        == ("1", "3")


def test_dp_ab_arms_equal_each_other_and_the_jax_mesh(monkeypatch):
    import jax
    from coverm_tpu.ops.depth import ReferenceLayout
    from coverm_tpu.parallel.mesh_sweep import (
        compute_depth_stats_sweep_mesh, make_shard_mesh)
    assert len(jax.devices()) == 8
    monkeypatch.setenv(D.CPU_DEVICES_VAR, "8")
    B = 40_000
    lines = []
    res, ra, rb = dp_ab_bench.run(B, 1, torch.device("cpu"),
                                  out=lines.append)
    assert res["devices"] == ["cpu"] * 8 and not res["one_card"]
    assert lines[-1].startswith("bit parity OK; stacked/thread wall ratio")
    layout, samples = dp_ab_bench.make_samples(B)
    jlayout = ReferenceLayout.build(layout.lengths, 75)
    mesh = make_shard_mesh(8)
    for s, (t, st, en) in enumerate(samples):
        want = compute_depth_stats_sweep_mesh(jlayout, t, st, en,
                                              trim=dp_ab_bench.TRIM,
                                              mesh=mesh)
        for f in dp_ab_bench.FIELDS:
            w = np.asarray(getattr(want, f))
            np.testing.assert_array_equal(getattr(ra[s], f), w, f)
            np.testing.assert_array_equal(getattr(rb[s], f), w, f)
