"""Coverage printers: the final TSV formats (coverage_printer.rs).

Four formats: streamed (already written by the taker), sparse cached,
dense cached, and MetaBAT-adjusted.  The cached printers apply the
whole-run normalisations (relative abundance, RPKM per mapped read, TPM)
with the reference's exact f32 expression trees — note the sparse and
dense printers multiply in *different orders* (coverage_printer.rs:281-288
vs :492-503) and the sparse TPM casts to f64 before the 1e6 scale
(:304-326) while the dense TPM stays in f32 (:521-542); both are
reproduced bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .floatfmt import format_f32
from .takers import CachedCoverageTaker, OutputWriter

f32 = np.float32
f64 = np.float64


@dataclass
class ReadsMapped:
    num_mapped_reads: int
    num_reads: int


class CoveragePrinter:
    def print_headers(self, entry_type: str, estimator_headers, stream: OutputWriter):
        pass

    def finalise_printing(self, taker, stream: OutputWriter, reads_mapped,
                          columns_to_normalise, rpkm_column, tpm_column):
        pass


class StreamedCoveragePrinter(CoveragePrinter):
    def print_headers(self, entry_type, estimator_headers, stream):
        stream.write("Sample\t" + entry_type)
        for h in estimator_headers:
            stream.write("\t" + h)
        stream.write("\n")


class SparseCachedCoveragePrinter(CoveragePrinter):
    def print_headers(self, entry_type, estimator_headers, stream):
        stream.write("Sample\t" + entry_type)
        for h in estimator_headers:
            stream.write("\t" + h)
        stream.write("\n")

    def finalise_printing(self, taker: CachedCoverageTaker, stream, reads_mapped,
                          columns_to_normalise, rpkm_column, tpm_column):
        nc = taker.num_coverages
        entry_names = taker.entry_names
        num_extra_entry_columns = 0
        for name in entry_names.values():
            num_extra_entry_columns = name.count("\t")
            break

        # group rows per stoit
        rows_by_stoit = [[] for _ in taker.stoit_names]
        for ecs in taker.iter_entries():
            rows_by_stoit[ecs.stoit_index].append(ecs)

        for si, stoit in enumerate(taker.stoit_names):
            rows = rows_by_stoit[si]
            coverage_totals = [None] * nc
            coverage_multipliers = [None] * nc
            for i in columns_to_normalise:
                total = f32(0.0)
                for ecs in rows:
                    total = total + ecs.coverages[i]
                coverage_totals[i] = total
                if reads_mapped is not None:
                    rm = reads_mapped[si]
                    coverage_multipliers[i] = f32(rm.num_mapped_reads) / f32(rm.num_reads)
            if tpm_column is not None:
                total = f32(0.0)
                for ecs in rows:
                    total = total + ecs.coverages[tpm_column]
                coverage_totals[tpm_column] = total

            # 'unmapped' pseudo-entry first (coverage_printer.rs:229-259)
            if columns_to_normalise:
                stream.write(f"{stoit}\tunmapped")
                stream.write("\t" * num_extra_entry_columns)
                for i, column in enumerate(columns_to_normalise):
                    lo = 0 if i == 0 else columns_to_normalise[i - 1] + 1
                    for _ in range(lo, column):
                        stream.write("\tNA")
                    v = f32(100.0) * (f32(1.0) - coverage_multipliers[column])
                    stream.write("\t" + format_f32(v))
                for _ in range(columns_to_normalise[-1] + 1, nc):
                    stream.write("\tNA")
                stream.write("\n")

            for ecs in rows:
                name = entry_names[ecs.entry_index].rstrip("\r")
                stream.write(f"{stoit}\t{name}")
                for i in range(nc):
                    cov = ecs.coverages[i]
                    if i in columns_to_normalise:
                        v = cov * f32(100.0) * coverage_multipliers[i] / coverage_totals[i]
                        stream.write("\t" + format_f32(v))
                    elif rpkm_column == i:
                        nmr = reads_mapped[si].num_mapped_reads
                        v = f32(0.0) if nmr == 0 else cov / f32(nmr)
                        stream.write("\t" + format_f32(v))
                    elif tpm_column == i:
                        nmr = reads_mapped[si].num_mapped_reads
                        if nmr == 0:
                            stream.write("\t0")
                        else:
                            with np.errstate(divide="ignore"):
                                v64 = f64(np.exp(np.log(cov) - np.log(
                                    coverage_totals[i]))) * f64(10**6)
                            from .floatfmt import format_f64
                            stream.write("\t" + format_f64(v64))
                    else:
                        stream.write("\t" + format_f32(cov))
                stream.write("\n")


class DenseCachedCoveragePrinter(CoveragePrinter):
    def __init__(self):
        self.entry_type = None
        self.estimator_headers = None

    def print_headers(self, entry_type, estimator_headers, stream):
        self.entry_type = entry_type
        self.estimator_headers = list(estimator_headers)

    def finalise_printing(self, taker: CachedCoverageTaker, stream, reads_mapped,
                          columns_to_normalise, rpkm_column, tpm_column):
        nc = taker.num_coverages
        entry_names = taker.entry_names
        stoit_names = taker.stoit_names

        stream.write(self.entry_type)
        for stoit in stoit_names:
            for h in self.estimator_headers:
                stream.write(f"\t{stoit} {h}")
        stream.write("\n")

        coverage_multipliers = []
        if reads_mapped is not None:
            for rm in reads_mapped:
                coverage_multipliers.append(f32(rm.num_mapped_reads) / f32(rm.num_reads))

        rows_by_stoit = [[] for _ in stoit_names]
        coverage_totals = [[None] * nc for _ in stoit_names]
        for ecs in taker.iter_entries():
            for i in columns_to_normalise:
                t = coverage_totals[ecs.stoit_index][i]
                coverage_totals[ecs.stoit_index][i] = (
                    ecs.coverages[i] if t is None else t + ecs.coverages[i])
            if tpm_column is not None:
                t = coverage_totals[ecs.stoit_index][tpm_column]
                coverage_totals[ecs.stoit_index][tpm_column] = (
                    ecs.coverages[tpm_column] if t is None else t + ecs.coverages[tpm_column])
            rows_by_stoit[ecs.stoit_index].append(ecs)

        if columns_to_normalise:
            stream.write("unmapped")
            stream.write("\t" * self.entry_type.count("\t"))
            for si, _ in enumerate(stoit_names):
                for i, column in enumerate(columns_to_normalise):
                    lo = 0 if i == 0 else columns_to_normalise[i - 1] + 1
                    for _ in range(lo, column):
                        stream.write("\tNA")
                    v = f32(100.0) * (f32(1.0) - coverage_multipliers[si])
                    stream.write("\t" + format_f32(v))
                for _ in range(columns_to_normalise[-1] + 1, nc):
                    stream.write("\tNA")
            stream.write("\n")

        if not rows_by_stoit or not rows_by_stoit[0]:
            return
        n_entries = len(rows_by_stoit[0])
        for ei in range(n_entries):
            name = entry_names[rows_by_stoit[0][ei].entry_index].rstrip("\r")
            stream.write(name)
            for si, rows in enumerate(rows_by_stoit):
                ecs = rows[ei]
                for i in range(nc):
                    cov = ecs.coverages[i]
                    if i in columns_to_normalise:
                        # divide first (coverage_printer.rs:496-500)
                        v = (cov / coverage_totals[ecs.stoit_index][i]
                             * f32(100.0) * coverage_multipliers[si])
                        stream.write("\t" + format_f32(v))
                    elif rpkm_column == i:
                        nmr = reads_mapped[si].num_mapped_reads
                        v = f32(0.0) if nmr == 0 else cov / f32(nmr)
                        stream.write("\t" + format_f32(v))
                    elif tpm_column == i:
                        nmr = reads_mapped[si].num_mapped_reads
                        if nmr == 0:
                            stream.write("\t0")
                        else:
                            with np.errstate(divide="ignore"):
                                v = f32(np.exp(np.log(cov) - np.log(
                                    coverage_totals[ecs.stoit_index][i]))) * f32(10**6)
                            stream.write("\t" + format_f32(v))
                    else:
                        stream.write("\t" + format_f32(cov))
            stream.write("\n")


class MetabatAdjustedCoveragePrinter(CoveragePrinter):
    """MetaBAT jgi_summarize_bam_contig_depths-style output
    (coverage_printer.rs:57-119): columns contigName, contigLen,
    totalAvgDepth, then per sample `<stoit>.bam` and `<stoit>.bam-var`,
    rounded to 4 decimals via f64."""

    def finalise_printing(self, taker: CachedCoverageTaker, stream, reads_mapped,
                          columns_to_normalise, rpkm_column, tpm_column):
        stream.write("contigName\tcontigLen\ttotalAvgDepth")
        for stoit in taker.stoit_names:
            stream.write(f"\t{stoit}.bam\t{stoit}.bam-var")
        stream.write("\n")

        rows_by_stoit = [[] for _ in taker.stoit_names]
        for ecs in taker.iter_entries():
            rows_by_stoit[ecs.stoit_index].append(ecs)
        if not rows_by_stoit or not rows_by_stoit[0]:
            return
        n_stoits = len(taker.stoit_names)
        from .floatfmt import format_f64
        for ei in range(len(rows_by_stoit[0])):
            total_depth = f32(0.0)
            for rows in rows_by_stoit:
                total_depth = total_depth + rows[ei].coverages[1]
            name = taker.entry_names[rows_by_stoit[0][ei].entry_index]
            length = rows_by_stoit[0][ei].coverages[0]
            avg = np.round(f64(total_depth) * f64(10000.0) / f64(n_stoits)) / f64(10000.0)
            stream.write(f"{name}\t{format_f32(length)}\t{format_f64(avg)}")
            for rows in rows_by_stoit:
                c = rows[ei].coverages
                m = np.round(f64(c[1]) * f64(10000.0)) / f64(10000.0)
                v = np.round(f64(c[2]) * f64(10000.0)) / f64(10000.0)
                stream.write(f"\t{format_f64(m)}\t{format_f64(v)}")
            stream.write("\n")
