"""Genome dereplication / clustering (the galah bridge, coverm.rs:1044-1133).

The reference delegates to the galah crate, which shells out to
skani/fastANI for pairwise ANI and orders genomes by CheckM quality.
This engine is self-contained: ANI is estimated from FracMinHash k-mer
sketches (Mash distance: ANI = 1 + ln(2j/(1+j))/k over the Jaccard j),
quality comes from CheckM/CheckM2/genome-info tables when provided
(quality formula: completeness - 4*contamination, galah's default) and
falls back to assembly size, and clustering is galah's greedy scheme:
walk genomes in quality order, each unclaimed genome becomes a
representative and claims everything within the ANI threshold.

Divergence note: ANI values are sketch estimates, not skani's
alignment-based ANI; thresholds behave equivalently for the 95-99%
dereplication ranges the CLI exposes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .io.fasta import iter_fasta

_CODE = np.full(256, 255, dtype=np.uint8)
for i, c in enumerate("ACGT"):
    _CODE[ord(c)] = i
    _CODE[ord(c.lower())] = i
_RC = np.array([3, 2, 1, 0], dtype=np.uint64)

# splitmix64 constants for k-mer hashing
_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = x + _SM_GAMMA
        z = (z ^ (z >> np.uint64(30))) * _SM_M1
        z = (z ^ (z >> np.uint64(27))) * _SM_M2
        return z ^ (z >> np.uint64(31))


def sketch_sequence_kmers(seq_codes: np.ndarray, k: int) -> np.ndarray:
    """Canonical k-mer integers of one sequence (codes 0-3, 255=ambiguous)."""
    n = seq_codes.size
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    valid = seq_codes != 255
    codes = np.where(valid, seq_codes, 0).astype(np.uint64)
    rc = _RC[codes]
    fwd = np.zeros(n - k + 1, dtype=np.uint64)
    rev = np.zeros(n - k + 1, dtype=np.uint64)
    ok = np.ones(n - k + 1, dtype=bool)
    with np.errstate(over="ignore"):
        for j in range(k):
            fwd = (fwd << np.uint64(2)) | codes[j : j + n - k + 1]
            rev = rev | (rc[j : j + n - k + 1] << np.uint64(2 * j))
            ok &= valid[j : j + n - k + 1]
    canon = np.minimum(fwd, rev)
    return canon[ok]


def sketch_genome(path: str, k: int = 21, scale: int = 1000) -> np.ndarray:
    """FracMinHash sketch: hashed canonical k-mers below 2^64/scale."""
    threshold = np.uint64((1 << 64) // scale)
    parts = []
    total_len = 0
    for _header, seq in iter_fasta(path):
        total_len += len(seq)
        codes = _CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]
        kmers = sketch_sequence_kmers(codes, k)
        if kmers.size:
            h = _splitmix64(kmers)
            parts.append(h[h < threshold])
    if not parts:
        return np.zeros(0, dtype=np.uint64), total_len
    return np.unique(np.concatenate(parts)), total_len


def sketch_ani(a: np.ndarray, b: np.ndarray, k: int = 21) -> float:
    """Mash-style ANI estimate from two sketches."""
    if a.size == 0 or b.size == 0:
        return 0.0
    inter = np.intersect1d(a, b, assume_unique=True).size
    union = a.size + b.size - inter
    if inter == 0 or union == 0:
        return 0.0
    j = inter / union
    return 100.0 * (1.0 + np.log(2.0 * j / (1.0 + j)) / k)


@dataclass
class GenomeQuality:
    completeness: float = 100.0
    contamination: float = 0.0

    def score(self, formula: str = "completeness-4contamination") -> float:
        if formula == "completeness-4contamination":
            return self.completeness - 4.0 * self.contamination
        if formula == "completeness-5contamination":
            return self.completeness - 5.0 * self.contamination
        return self.completeness - 4.0 * self.contamination


def read_checkm_tab_table(path: str) -> dict:
    """CheckM `--tab_table` output: name, ..., completeness, contamination."""
    out = {}
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        try:
            ci = header.index("Completeness")
            coi = header.index("Contamination")
        except ValueError:
            ci, coi = 11, 12  # classic checkm qa column positions
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) <= max(ci, coi):
                continue
            out[cols[0]] = GenomeQuality(float(cols[ci]), float(cols[coi]))
    return out


def read_checkm2_quality_report(path: str) -> dict:
    out = {}
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        ni = header.index("Name") if "Name" in header else 0
        ci = header.index("Completeness") if "Completeness" in header else 1
        coi = header.index("Contamination") if "Contamination" in header else 2
        for line in f:
            cols = line.rstrip("\n").split("\t")
            out[cols[ni]] = GenomeQuality(float(cols[ci]), float(cols[coi]))
    return out


def read_genome_info(path: str) -> dict:
    """drep genomeInfo csv: genome,completeness,contamination."""
    out = {}
    with open(path) as f:
        header = f.readline()
        for line in f:
            cols = line.rstrip("\n").split(",")
            if len(cols) >= 3:
                name = cols[0]
                for ext in (".fna", ".fa", ".fasta"):
                    if name.endswith(ext):
                        name = name[: -len(ext)]
                out[name] = GenomeQuality(float(cols[1]), float(cols[2]))
    return out


def candidate_adjacency(sketches):
    """Precluster stage (galah's dashing/finch prefilter analogue,
    coverm.rs:1093-1102): an inverted hash->genome index yields, for each
    genome, the set of genomes sharing >=1 sketch hash.  For the sketch
    engine this is EXACT, not approximate: a pair sharing no hash has
    sketch ANI 0, so it could never cluster anyway.  Cost is
    O(total sketch size + shared pairs) instead of O(n^2) full
    comparisons."""
    n = len(sketches)
    if n == 0:
        return [set() for _ in range(n)]
    ids = np.concatenate([
        np.full(s.size, i, np.int32) for i, s in enumerate(sketches)] or
        [np.zeros(0, np.int32)])
    hs = np.concatenate(sketches) if ids.size else np.zeros(0, np.uint64)
    order = np.argsort(hs, kind="stable")
    hs, ids = hs[order], ids[order]
    adj = [set() for _ in range(n)]
    if hs.size == 0:
        return adj
    new = np.concatenate(([0], np.flatnonzero(hs[1:] != hs[:-1]) + 1,
                          [hs.size]))
    for a, b in zip(new[:-1], new[1:]):
        if b - a > 1:
            grp = np.unique(ids[a:b])
            for x in range(grp.size):
                gx = int(grp[x])
                for y in range(x + 1, grp.size):
                    gy = int(grp[y])
                    adj[gx].add(gy)
                    adj[gy].add(gx)
    return adj


def _external_ani(method, rep_path, cand_paths, threads=1,
                  min_aligned_fraction=0.15, fragment_length=3000):
    """Pairwise ANI of rep vs candidates via an external engine (the
    reference's dependency model: galah shells out to skani/fastANI).

    Returns {candidate_path: ani_percent} for pairs passing the
    aligned-fraction gate."""
    import shutil
    import subprocess
    import tempfile

    exe = {"skani": "skani", "fastani": "fastANI"}[method]
    if shutil.which(exe) is None:
        raise SystemExit(
            f"--cluster-method {method} requires the {exe} executable on "
            "$PATH (install it, or use the built-in sketch method)")
    out = {}
    with tempfile.TemporaryDirectory(prefix="coverm-tpu-ani") as td:
        rl = os.path.join(td, "refs.txt")
        with open(rl, "w") as f:
            f.write("\n".join(cand_paths) + "\n")
        if method == "skani":
            cmd = ["skani", "dist", "-q", rep_path, "--rl", rl,
                   "-t", str(threads), "--min-af",
                   str(min_aligned_fraction * 100.0)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise SystemExit(f"skani dist failed: {res.stderr[-2000:]}")
            for line in res.stdout.splitlines()[1:]:
                cols = line.split("\t")
                if len(cols) >= 3:
                    out[cols[0]] = float(cols[2])
        else:
            of = os.path.join(td, "out.tsv")
            cmd = ["fastANI", "-q", rep_path, "--rl", rl, "-o", of,
                   "-t", str(threads), "--fragLen", str(int(fragment_length))]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise SystemExit(f"fastANI failed: {res.stderr[-2000:]}")
            with open(of) as f:
                for line in f:
                    cols = line.split("\t")
                    if len(cols) >= 5:
                        frac = int(cols[3]) / max(int(cols[4]), 1)
                        if frac >= min_aligned_fraction:
                            out[cols[1]] = float(cols[2])
    return out


@dataclass
class Clusterer:
    genome_paths: list
    ani: float = 95.0
    precluster_ani: float = 90.0
    min_aligned_fraction: float = 0.15  # skani/fastANI gate
    fragment_length: float = 3000.0     # fastANI --fragLen
    quality: dict = field(default_factory=dict)  # stem -> GenomeQuality
    quality_formula: str = "completeness-4contamination"
    k: int = 21
    scale: int = 1000
    reference_genomes: list = None  # pre-clustered representatives
    cluster_method: str = "sketch"  # sketch | skani | fastani
    threads: int = 1

    def cluster(self):
        """Return clusters as lists of indices into genome_paths; index 0 of
        each cluster is the representative (galah's greedy quality-ordered
        scheme behind coverm.rs:1093-1102)."""
        from .genome_parsing import genome_name_from_path

        n = len(self.genome_paths)
        sketches = []
        sizes = []
        for p in self.genome_paths:
            s, total = sketch_genome(p, self.k, self.scale)
            sketches.append(s)
            sizes.append(total)

        def quality_key(i):
            stem = genome_name_from_path(self.genome_paths[i])
            q = self.quality.get(stem)
            score = q.score(self.quality_formula) if q else 0.0
            return (-score, -sizes[i], i)

        ref_set = set()
        if self.reference_genomes:
            ref_idx = {p: i for i, p in enumerate(self.genome_paths)}
            ref_set = {ref_idx[p] for p in self.reference_genomes
                       if p in ref_idx}
        order = sorted(range(n), key=quality_key)
        # reference genomes are fixed representatives, claimed first
        order = ([i for i in order if i in ref_set]
                 + [i for i in order if i not in ref_set])

        adj = candidate_adjacency(sketches)
        assigned = np.full(n, -1, dtype=np.int64)
        clusters = []
        for i in order:
            if assigned[i] >= 0:
                continue
            cluster_id = len(clusters)
            members = [i]
            assigned[i] = cluster_id
            cands = sorted(j for j in adj[i] if assigned[j] < 0)
            if cands and self.cluster_method in ("skani", "fastani"):
                # sketch precluster at precluster_ani, exact ANI externally
                cands = [j for j in cands
                         if sketch_ani(sketches[i], sketches[j], self.k)
                         >= self.precluster_ani]
                ani_of = _external_ani(
                    self.cluster_method, self.genome_paths[i],
                    [self.genome_paths[j] for j in cands],
                    threads=self.threads,
                    min_aligned_fraction=self.min_aligned_fraction,
                    fragment_length=self.fragment_length) if cands else {}
                for j in cands:
                    if ani_of.get(self.genome_paths[j], 0.0) >= self.ani:
                        assigned[j] = cluster_id
                        members.append(j)
            else:
                for j in cands:
                    if sketch_ani(sketches[i], sketches[j], self.k) >= self.ani:
                        assigned[j] = cluster_id
                        members.append(j)
            clusters.append(members)
        return clusters


def run_checkm2(genome_fasta_files, db_path=None, threads=1):
    """--run-checkm2: predict genome qualities with an external `checkm2
    predict` run instead of a pre-made table (galah bridge, cli.rs:41-42).
    Returns a stem -> GenomeQuality dict."""
    import shutil
    import subprocess
    import tempfile

    if shutil.which("checkm2") is None:
        raise SystemExit(
            "--run-checkm2 requires the checkm2 executable on $PATH")
    with tempfile.TemporaryDirectory(prefix="coverm-tpu-checkm2") as td:
        cmd = ["checkm2", "predict", "--input", *genome_fasta_files,
               "--output-directory", os.path.join(td, "out"),
               "--threads", str(threads), "--force"]
        if db_path:
            cmd += ["--database_path", db_path]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(
                f"checkm2 predict failed: {res.stderr[-2000:]}")
        report = os.path.join(td, "out", "quality_report.tsv")
        return read_checkm2_quality_report(report)


def resolve_quality(args, genome_fasta_files, threads=1):
    """Gather genome qualities from every provided source (tables and/or a
    live CheckM2 run)."""
    quality = {}
    if getattr(args, "checkm_tab_table", None):
        quality.update(read_checkm_tab_table(args.checkm_tab_table))
    if getattr(args, "checkm2_quality_report", None):
        quality.update(read_checkm2_quality_report(args.checkm2_quality_report))
    if getattr(args, "genome_info", None):
        quality.update(read_genome_info(args.genome_info))
    if getattr(args, "run_checkm2", False):
        quality.update(run_checkm2(
            genome_fasta_files, getattr(args, "checkm2_db_path", None),
            threads=threads))
    return quality


def _sketch_scale(args, prefix="dereplication_"):
    """Sketch density from the galah granularity knobs: small genomes or
    small contigs need denser sketches for stable Jaccard estimates;
    large contigs can use sparser ones (cli.rs:1420-1446 analogues)."""
    g = lambda k: getattr(args, prefix + k, False) or getattr(args, k, False)
    if g("small_genomes") or g("small_contigs") or g("cluster_contigs"):
        return 100
    if g("large_contigs"):
        return 2000
    return 1000


def _explode_contigs(genome_fasta_files):
    """--dereplication-cluster-contigs: treat every contig as its own
    clustering unit by writing one FASTA per contig into a tempdir (kept
    alive for the process)."""
    import tempfile

    td = tempfile.mkdtemp(prefix="coverm-tpu-contigs")
    _explode_contigs._keep.append(td)
    from .genome_parsing import genome_name_from_path
    out = []
    for path in genome_fasta_files:
        stem = genome_name_from_path(path)
        for i, (header, seq) in enumerate(iter_fasta(path)):
            name = header.split()[0]
            safe = "".join(ch if ch.isalnum() or ch in "._-" else "_"
                           for ch in name)
            p = os.path.join(td, f"{stem}~{i}_{safe}.fna")
            with open(p, "w") as f:
                f.write(f">{name}\n{seq}\n")
            out.append(p)
    return out


_explode_contigs._keep = []


def dereplicate(args, genome_fasta_files):
    """--dereplicate flow (coverm.rs:1044-1133): cluster, write outputs,
    return representative paths."""
    quality = resolve_quality(args, genome_fasta_files,
                              threads=getattr(args, "threads", 1))

    if (getattr(args, "dereplication_cluster_contigs", False)
            or getattr(args, "cluster_contigs", False)):
        genome_fasta_files = _explode_contigs(genome_fasta_files)

    refs = list(getattr(args, "dereplication_reference_genomes", None) or [])
    ref_list = (getattr(args, "dereplication_reference_genomes_list", None)
                or getattr(args, "reference_genomes_list", None))
    if ref_list:
        with open(ref_list) as f:
            refs.extend(line.strip() for line in f if line.strip())
    combined = refs + [g for g in genome_fasta_files if g not in refs]

    g = lambda k, dflt=None: (getattr(args, "dereplication_" + k, None)
                              if getattr(args, "dereplication_" + k, None)
                              is not None else getattr(args, k, dflt))
    method = (g("cluster_method", "skani") or "skani").lower()
    if method in ("skani", "fastani"):
        # fail loudly like the reference does when its ANI engine is
        # missing (galah checks its skani/fastANI dependency up front);
        # the built-in sketch engine must be requested EXPLICITLY
        # (--cluster-method sketch) because sketch estimates are not
        # alignment ANI and silently swapping them would change results
        # under identical flags
        import shutil
        exe = {"skani": "skani", "fastani": "fastANI"}[method]
        if shutil.which(exe) is None:
            raise SystemExit(
                f"Error: --cluster-method {method} requires the {exe} "
                "executable on $PATH. Install it, or explicitly request "
                "the built-in sketch engine with --cluster-method sketch.")
    clusterer = Clusterer(
        genome_paths=combined,
        ani=float(getattr(args, "dereplication_ani", None)
                  or getattr(args, "ani", 95.0)),
        precluster_ani=float(getattr(args, "dereplication_prethreshold_ani",
                                     None) or 90.0),
        min_aligned_fraction=float(g("aligned_fraction", 15.0) or 15.0) / 100.0,
        fragment_length=float(g("fragment_length", 3000) or 3000),
        quality=quality,
        quality_formula=getattr(args, "dereplication_quality_formula", None)
        or getattr(args, "quality_formula", None)
        or "completeness-4contamination",
        reference_genomes=refs or None,
        scale=_sketch_scale(args),
        cluster_method=method,
        threads=int(getattr(args, "threads", 1) or 1),
    )
    clusters = clusterer.cluster()
    reps = [combined[c[0]] for c in clusters]

    out_def = (getattr(args, "dereplication_output_cluster_definition", None)
               or getattr(args, "output_cluster_definition", None))
    if out_def:
        with open(out_def, "w") as f:
            for c in clusters:
                for member in c:
                    f.write(f"{combined[c[0]]}\t{combined[member]}\n")
    out_list = (getattr(args, "dereplication_output_representative_list", None)
                or getattr(args, "output_representative_list", None))
    if out_list:
        with open(out_list, "w") as f:
            for r in reps:
                f.write(r + "\n")
    out_dir = (getattr(args,
                       "dereplication_output_representative_fasta_directory",
                       None)
               or getattr(args, "output_representative_fasta_directory", None))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for r in reps:
            dst = os.path.join(out_dir, os.path.basename(r))
            if not os.path.exists(dst):
                os.symlink(os.path.abspath(r), dst)
    out_dir_copy = (
        getattr(args,
                "dereplication_output_representative_fasta_directory_copy",
                None)
        or getattr(args, "output_representative_fasta_directory_copy", None))
    if out_dir_copy:
        import shutil
        os.makedirs(out_dir_copy, exist_ok=True)
        for r in reps:
            dst = os.path.join(out_dir_copy, os.path.basename(r))
            if not os.path.exists(dst):
                shutil.copyfile(r, dst)
    return reps
