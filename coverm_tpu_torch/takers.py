"""Coverage takers: the sink between estimators and printers.

Mirrors coverage_takers.rs: a streaming single-float printer, a pileup
(histogram) printer, and a cached taker whose merge iterator yields
entries in increasing entry-order with zero-fill for entries a sample
never produced (coverage_takers.rs:228-377).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from .floatfmt import format_f32


class OutputWriter:
    """Write to stdout or a file (lib.rs:81-134)."""

    def __init__(self, path=None, fileobj=None):
        if fileobj is not None:
            self._f = fileobj
            self._own = False
        elif path is None or path == "-":
            self._f = sys.stdout
            self._own = False
        else:
            self._f = open(path, "w")
            self._own = True

    def write(self, s: str):
        self._f.write(s)

    def flush(self):
        self._f.flush()

    def close(self):
        if self._own:
            self._f.close()


class CoverageTaker:
    def start_stoit(self, stoit_name: str): ...
    def start_entry(self, entry_order_id: int, entry_name: str): ...
    def add_single_coverage(self, coverage): ...
    def add_coverage_entry(self, num_reads: int, num_bases: int): ...
    def finish_entry(self): ...


class StreamingCoverageTaker(CoverageTaker):
    """Writes `stoit\tentry\tcov...` rows as they are produced."""

    def __init__(self, stream: OutputWriter):
        self.stream = stream
        self.current_stoit = None

    def start_stoit(self, stoit_name):
        self.current_stoit = stoit_name

    def start_entry(self, entry_order_id, entry_name):
        self.stream.write(f"{self.current_stoit}\t{entry_name}")

    def add_single_coverage(self, coverage):
        v = np.float32(coverage)
        if v == 0.0:
            self.stream.write("\t0")
        else:
            self.stream.write("\t" + format_f32(v))

    def finish_entry(self):
        self.stream.write("\n")


class PileupCoverageTaker(CoverageTaker):
    """Histogram rows `stoit\tentry\tdepth\tcount` (coverage_takers.rs:188-208)."""

    def __init__(self, stream: OutputWriter):
        self.stream = stream
        self.current_stoit = None
        self.current_entry = None

    def start_stoit(self, stoit_name):
        self.current_stoit = stoit_name

    def start_entry(self, entry_order_id, entry_name):
        self.current_entry = entry_name

    def add_coverage_entry(self, num_reads, num_bases):
        self.stream.write(
            f"{self.current_stoit}\t{self.current_entry}\t{num_reads}\t{num_bases}\n")

    def finish_entry(self):
        pass


@dataclass
class EntryAndCoverages:
    entry_index: int
    stoit_index: int
    coverages: list


class CachedCoverageTaker(CoverageTaker):
    """Caches all coverages for post-hoc normalisation / dense output."""

    def __init__(self, num_coverages: int):
        self.num_coverages = num_coverages
        self.stoit_names = []
        self.entry_names = {}  # entry_order_id -> name
        self.coverages = []  # per stoit: list[(entry_index, cov)]
        self._cur = None

    def start_stoit(self, stoit_name):
        self.stoit_names.append(stoit_name)
        self.coverages.append([])

    def start_entry(self, entry_order_id, entry_name):
        prev = self.entry_names.get(entry_order_id)
        if prev is None:
            self.entry_names[entry_order_id] = entry_name
        elif prev != entry_name:
            raise RuntimeError(
                "Found a difference amongst the reference sets used for "
                "mapping. For this (non-streaming) usage, all BAM files must "
                f"have the same set of reference sequences. Previous entry was "
                f"{prev}, new is {entry_name}")
        self._cur = entry_order_id

    def add_single_coverage(self, coverage):
        self.coverages[-1].append((self._cur, np.float32(coverage)))

    def finish_entry(self):
        pass

    def iter_entries(self):
        """Merge iterator: for each stoit, yield the union of entry indices
        (across all stoits) in increasing order, zero-filling entries this
        stoit did not record (coverage_takers.rs:265-377)."""
        nc = self.num_coverages
        per_stoit = []
        for rows in self.coverages:
            d = {}
            for i in range(0, len(rows), nc):
                d[rows[i][0]] = [c for (_, c) in rows[i : i + nc]]
            per_stoit.append(d)
        all_indices = sorted({e for d in per_stoit for e in d})
        for si in range(len(self.stoit_names)):
            for ei in all_indices:
                covs = per_stoit[si].get(ei)
                if covs is None:
                    covs = [np.float32(0.0)] * nc
                yield EntryAndCoverages(entry_index=ei, stoit_index=si, coverages=covs)
