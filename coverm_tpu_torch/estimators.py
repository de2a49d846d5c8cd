"""Coverage estimator suite.

Each estimator consumes integer per-entity statistics (accumulated over
the observed contigs of a contig/genome entity) plus the list of
unobserved contig lengths, and reproduces the reference's exact f32
arithmetic (mosdepth_genome_coverage_estimators.rs):

  mean            :532-565   trimmed_mean      :566-647
  coverage_histogram (pileup) :648-678, print :952-967
  covered_fraction:679-695   covered_bases     :696-712
  rpkm            :713-737   tpm               :738-763
  variance (shifted, sample) :764-813          length :814-817
  count           :818       reads_per_base    :819-826
  anir            :827-836

All accumulators in the reference are u64/f64; floats only appear in the
final expressions, so results here are bit-identical.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

f32 = np.float32
f64 = np.float64


def unobserved_bases(unobserved_lengths, contig_end_exclusion: int) -> int:
    """calculate_unobserved_bases (estimators.rs:226-243).

    Note the quirk: an unobserved contig shorter than 2*exclusion
    contributes its *full* length (not zero)."""
    e = 2 * contig_end_exclusion
    total = 0
    for l in unobserved_lengths:
        total += l if l < e else l - e
    return int(total)


@dataclass
class EntityStats:
    """Integer statistics accumulated over an entity's observed contigs.

    Mirrors the union of the reference estimator states after their
    add_contig calls (estimators.rs:366-528)."""

    # Mean-group state (only contigs with len > 2*exclusion contribute
    # bases/count/covered; reads and mismatches always accumulate)
    total_count: int = 0        # Σ depth inside exclusion window
    total_bases_window: int = 0  # Σ (len - 2*exclusion)
    covered_window: int = 0     # positions depth>0 inside window
    # fraction-group state (full contig, no exclusion)
    total_bases_full: int = 0   # Σ len over observed contigs
    covered_full: int = 0       # positions depth>0 anywhere
    # histogram-group state (inside exclusion window)
    hist: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # length-group state
    observed_length_full: int = 0  # Σ len over observed contigs
    # read-level
    reads: int = 0              # mode-appropriate mapped-read count
    mismatches: int = 0         # Σ (NM - indels)
    sum_identity: float = 0.0   # Σ (aligned-NM)/aligned  (f64)
    # unobserved contigs of this entity
    unobserved_lengths: list = field(default_factory=list)

    def hist_trimmed(self) -> np.ndarray:
        """Reference counts vec: length = max observed depth + 1."""
        nz = np.flatnonzero(self.hist)
        if nz.size == 0:
            return self.hist[:1] if self.total_bases_window > 0 else self.hist[:0]
        return self.hist[: nz[-1] + 1]


@dataclass
class BatchStats:
    """Column-wise EntityStats over C entities.

    Enables vectorised estimator evaluation — the scalar ``calculate``
    path costs ~100us/entity in Python, which dominates assembly-scale
    runs (500k contigs / 100k genomes); the batch path is a handful of
    numpy passes.  In contig mode every entity is one observed contig
    and the unobserved columns are zero; in genome mode entities are
    genomes aggregated by segment reductions, with the unobserved-contig
    bookkeeping (genome.rs:448-499) carried in the two columns below.
    """

    total_count: np.ndarray          # int64[C]
    total_bases_window: np.ndarray   # int64[C]
    covered_window: np.ndarray       # int64[C]
    total_bases_full: np.ndarray     # int64[C]
    covered_full: np.ndarray         # int64[C]
    observed_length_full: np.ndarray  # int64[C]
    reads: np.ndarray                # int64[C]
    mismatches: np.ndarray           # int64[C]
    sum_identity: np.ndarray         # f64[C]
    hist: np.ndarray | None = None   # int64[C, D]
    # unobserved-contig contributions (calculate_unobserved_bases quirk
    # included: a contig shorter than 2*exclusion adds its FULL length)
    unobserved_window_bases: np.ndarray | int = 0  # int64[C]
    unobserved_full_bases: np.ndarray | int = 0    # int64[C]
    # moments: enough for variance without a histogram
    sumsq_window: np.ndarray | None = None      # int64[C] Σ depth² in window
    min_depth_window: np.ndarray | None = None  # int64[C] min depth in window
    # device-computed trimmed-mean numerators (rank-range sums); when
    # present, TrimmedMean needs no histogram either
    trimmed_sum: np.ndarray | None = None       # int64[C]


def _f32(a):
    return np.asarray(a).astype(np.float32)


class Estimator:
    """Base estimator: configuration + pure functions over EntityStats."""

    headers: tuple = ()
    uses_window = False   # needs exclusion-window stats
    uses_hist = False     # needs the depth histogram (scalar path)
    # histogram requirement of calculate_batch (variance derives from
    # moments instead, so batch contig runs skip the histogram entirely)
    uses_hist_batch = False

    def calculate(self, s: EntityStats) -> np.float32:
        raise NotImplementedError

    def calculate_batch(self, b: BatchStats) -> np.ndarray:
        """Vectorised calculate over BatchStats; float32[C].  Must agree
        bit-for-bit with ``calculate`` on per-contig stats."""
        raise NotImplementedError

    def zero_entry_value(self, entry_length: int):
        """Value used by print_zero_coverage (estimators.rs:971-991).
        None means 0.0; Length overrides."""
        return f32(0.0)


@dataclass
class MeanEstimator(Estimator):
    min_fraction_covered_bases: float = 0.0
    contig_end_exclusion: int = 0
    exclude_mismatches: bool = False
    headers = ("Mean",)
    uses_window = True

    def calculate(self, s: EntityStats) -> np.float32:
        final_total = s.total_bases_window + unobserved_bases(
            s.unobserved_lengths, self.contig_end_exclusion)
        if final_total == 0 or (
            f32(s.covered_window) / f32(final_total) < f32(self.min_fraction_covered_bases)
        ):
            return f32(0.0)
        numer = s.total_count - s.mismatches if self.exclude_mismatches else s.total_count
        return f32(numer) / f32(final_total)

    def calculate_batch(self, b: BatchStats) -> np.ndarray:
        final_total = b.total_bases_window + b.unobserved_window_bases
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = _f32(b.covered_window) / _f32(final_total)
            numer = (b.total_count - b.mismatches if self.exclude_mismatches
                     else b.total_count)
            out = _f32(numer) / _f32(final_total)
        gate = (final_total == 0) | (frac < f32(self.min_fraction_covered_bases))
        out[gate] = f32(0.0)
        return out


@dataclass
class TrimmedMeanEstimator(Estimator):
    trim_min: float = 0.05
    trim_max: float = 0.95
    min_fraction_covered_bases: float = 0.0
    contig_end_exclusion: int = 0
    headers = ("Trimmed Mean",)
    uses_window = True
    uses_hist = True
    uses_hist_batch = True

    def calculate(self, s: EntityStats) -> np.float32:
        unobs = unobserved_bases(s.unobserved_lengths, self.contig_end_exclusion)
        total_bases = s.total_bases_window + unobs
        if total_bases == 0:
            return f32(0.0)
        if f32(s.covered_window) / f32(total_bases) < f32(self.min_fraction_covered_bases):
            return f32(0.0)
        min_index = int(math.floor(f32(self.trim_min) * f32(total_bases)))
        max_index = int(math.ceil(f32(self.trim_max) * f32(total_bases)))
        if s.covered_window == 0:
            return f32(0.0)
        counts = s.hist_trimmed().copy()
        if counts.size == 0:
            counts = np.zeros(1, dtype=np.int64)
        counts[0] += unobs
        # histogram CDF walk, exactly estimators.rs:598-643
        num_accounted_for = 0
        total = 0
        started = False
        for i, num_covered in enumerate(counts.tolist()):
            num_accounted_for += num_covered
            if num_accounted_for >= min_index:
                if started:
                    if num_accounted_for > max_index:
                        num_excess = num_accounted_for - num_covered
                        num_wanted = (
                            max_index - num_excess + 1 if max_index >= num_excess else 0
                        )
                        total += num_wanted * i
                        break
                    else:
                        total += num_covered * i
                elif num_accounted_for > max_index:
                    # all coverages are the same in the trimmed set
                    total = (max_index - min_index + 1) * i
                    started = True
                elif num_accounted_for < min_index:
                    pass
                else:
                    num_wanted = num_accounted_for - min_index + 1
                    total = num_wanted * i
                    started = True
        # max_index == min_index divides by zero — exact reference
        # parity (estimators.rs:643 performs the same f32 division and
        # propagates inf/nan); suppress the RuntimeWarning so parity
        # does not look like a fault in every affected run
        with np.errstate(divide="ignore", invalid="ignore"):
            return f32(total) / f32(max_index - min_index)

    def trim_bounds(self, total_bases: np.ndarray):
        """(lo, hi) trim indices per entity — f32 arithmetic as the
        reference (estimators.rs:595-597)."""
        lo = np.floor(f32(self.trim_min) * _f32(total_bases)).astype(np.int64)
        hi = np.ceil(f32(self.trim_max) * _f32(total_bases)).astype(np.int64)
        return lo, hi

    def calculate_batch(self, b: BatchStats) -> np.ndarray:
        unobs = b.unobserved_window_bases
        total_bases = b.total_bases_window + unobs
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = _f32(b.covered_window) / _f32(total_bases)
        gate = ((total_bases == 0)
                | (frac < f32(self.min_fraction_covered_bases))
                | (b.covered_window == 0))
        lo, hi = self.trim_bounds(total_bases)
        if b.trimmed_sum is not None and np.all(np.asarray(unobs) == 0):
            total = b.trimmed_sum  # device-computed rank-range sum
        else:
            counts = b.hist.copy()
            counts[:, 0] += unobs
            total = trimmed_total_from_hist(counts, lo, hi)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = _f32(total) / _f32(hi - lo)
        out[gate] = f32(0.0)
        return out


def trimmed_total_from_hist(counts: np.ndarray, lo: np.ndarray,
                            hi: np.ndarray) -> np.ndarray:
    """Closed form of the trimmed-mean CDF walk, in rank space: with
    cum = inclusive CDF, lo/hi the trim indices, the walk takes ranks
    [lo, cum_{i_start}] at the first bin reaching lo, whole bins while
    cum <= hi, and [cum_{i_end-1}+1, hi+1] at the first bin exceeding hi
    — except when one bin spans both bounds, which contributes (hi-lo+1)
    items (the reference's separate branch, one fewer than the boundary
    formulas would give).  Returns the integer numerators int64[C]."""
    C, D = counts.shape
    cum = np.cumsum(counts, axis=1)
    x = np.arange(D, dtype=np.int64)
    W = np.cumsum(counts * x, axis=1)  # cumsum of depth-weighted counts

    reach_lo = cum >= lo[:, None]
    i_start = np.argmax(reach_lo, axis=1)
    started = reach_lo[:, -1]
    over_hi = cum > hi[:, None]
    has_end = over_hi[:, -1]
    i_end = np.where(has_end, np.argmax(over_hi, axis=1), D - 1)

    rows = np.arange(C)
    cum_start = cum[rows, i_start]
    cum_before_end = np.where(i_end > 0, cum[rows, np.maximum(i_end - 1, 0)], 0)
    single = has_end & (i_start == i_end)

    first_term = (cum_start - lo + 1) * i_start
    # whole bins strictly between the boundary bins; when hi is never
    # exceeded the walk runs through the final bin
    middle_end = np.where(has_end, np.maximum(i_end - 1, 0), D - 1)
    middle = W[rows, middle_end] - W[rows, i_start]
    middle = np.where(middle_end > i_start, middle, 0)
    last_term = np.where(
        has_end & (hi >= cum_before_end),
        (hi - cum_before_end + 1) * i_end, 0)
    last_term = np.where(i_end > i_start, last_term, 0)
    total = np.where(single, (hi - lo + 1) * i_start,
                     first_term + middle + last_term)
    return np.where(started, total, 0)


@dataclass
class PileupCountsEstimator(Estimator):
    min_fraction_covered_bases: float = 0.0
    contig_end_exclusion: int = 0
    headers = ("Coverage", "Bases")
    uses_window = True
    uses_hist = True

    def calculate(self, s: EntityStats) -> np.float32:
        if s.total_bases_window == 0:
            return f32(0.0)
        total_bases = s.total_bases_window + unobserved_bases(
            s.unobserved_lengths, self.contig_end_exclusion)
        if f32(s.covered_window) / f32(total_bases) < f32(self.min_fraction_covered_bases):
            return f32(0.0)
        # "Hack": the number of zero-coverage bases + 1 (estimators.rs:671-674)
        return f32(total_bases - s.covered_window + 1)

    def calculate_batch(self, b: BatchStats) -> np.ndarray:
        gate0 = b.total_bases_window == 0
        total_bases = b.total_bases_window + b.unobserved_window_bases
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = _f32(b.covered_window) / _f32(total_bases)
        out = _f32(total_bases - b.covered_window + 1)
        out[gate0
            | (frac < f32(self.min_fraction_covered_bases))] = f32(0.0)
        return out

    def histogram_rows(self, coverage: np.float32, s: EntityStats):
        """Rows for print_coverage (estimators.rs:952-967): (depth, count)."""
        counts = s.hist_trimmed()
        rows = []
        for i, num_covered in enumerate(counts.tolist()):
            if i == 0:
                c = int(np.floor(coverage))
                rows.append((0, 0 if c == 0 else c - 1))
            else:
                rows.append((i, num_covered))
        return rows


@dataclass
class CoveredFractionEstimator(Estimator):
    min_fraction_covered_bases: float = 0.0
    headers = ("Covered Fraction",)

    def calculate(self, s: EntityStats) -> np.float32:
        final_total = s.total_bases_full + sum(s.unobserved_lengths)
        if final_total == 0 or (
            f32(s.covered_full) / f32(final_total) < f32(self.min_fraction_covered_bases)
        ):
            return f32(0.0)
        return f32(s.covered_full) / f32(final_total)

    def calculate_batch(self, b: BatchStats) -> np.ndarray:
        final_total = b.total_bases_full + b.unobserved_full_bases
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = _f32(b.covered_full) / _f32(final_total)
        out = frac.copy()
        out[(final_total == 0)
            | (frac < f32(self.min_fraction_covered_bases))] = f32(0.0)
        return out


@dataclass
class CoveredBasesEstimator(Estimator):
    min_fraction_covered_bases: float = 0.0
    headers = ("Covered Bases",)

    def calculate(self, s: EntityStats) -> np.float32:
        final_total = s.total_bases_full + sum(s.unobserved_lengths)
        if final_total == 0 or (
            f32(s.covered_full) / f32(final_total) < f32(self.min_fraction_covered_bases)
        ):
            return f32(0.0)
        return f32(s.covered_full)

    def calculate_batch(self, b: BatchStats) -> np.ndarray:
        final_total = b.total_bases_full + b.unobserved_full_bases
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = _f32(b.covered_full) / _f32(final_total)
        out = _f32(b.covered_full)
        out[(final_total == 0)
            | (frac < f32(self.min_fraction_covered_bases))] = f32(0.0)
        return out


@dataclass
class RPKMEstimator(Estimator):
    min_fraction_covered_bases: float = 0.0
    headers = ("RPKM",)

    def calculate(self, s: EntityStats) -> np.float32:
        final_total = s.total_bases_full + sum(s.unobserved_lengths)
        if final_total == 0 or (
            f32(s.covered_full) / f32(final_total) < f32(self.min_fraction_covered_bases)
        ):
            return f32(0.0)
        # Pre-normalisation: reads*1e9/len; divided by mapped reads in the
        # printer (estimators.rs:727-735)
        return f32(s.reads * 10**9) / f32(final_total)

    def calculate_batch(self, b: BatchStats) -> np.ndarray:
        final_total = b.total_bases_full + b.unobserved_full_bases
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = _f32(b.covered_full) / _f32(final_total)
            out = _f32(b.reads * 10**9) / _f32(final_total)
        out[(final_total == 0)
            | (frac < f32(self.min_fraction_covered_bases))] = f32(0.0)
        return out


@dataclass
class TPMEstimator(Estimator):
    min_fraction_covered_bases: float = 0.0
    headers = ("TPM",)

    def calculate(self, s: EntityStats) -> np.float32:
        final_total = s.total_bases_full + sum(s.unobserved_lengths)
        if final_total == 0 or (
            f32(s.covered_full) / f32(final_total) < f32(self.min_fraction_covered_bases)
        ):
            return f32(0.0)
        if s.reads == 0:
            # ln(0) = -inf -> exp = 0 in the reference too
            return f32(0.0)
        return f32(np.exp(np.log(f64(s.reads)) - np.log(f64(final_total))))

    def calculate_batch(self, b: BatchStats) -> np.ndarray:
        final_total = b.total_bases_full + b.unobserved_full_bases
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = _f32(b.covered_full) / _f32(final_total)
            out = np.exp(np.log(b.reads.astype(f64))
                         - np.log(final_total.astype(f64))).astype(np.float32)
        out[(final_total == 0) | (b.reads == 0)
            | (frac < f32(self.min_fraction_covered_bases))] = f32(0.0)
        return out


@dataclass
class VarianceEstimator(Estimator):
    min_fraction_covered_bases: float = 0.0
    contig_end_exclusion: int = 0
    headers = ("Variance",)
    uses_window = True
    uses_hist = True

    def calculate(self, s: EntityStats) -> np.float32:
        unobs = unobserved_bases(s.unobserved_lengths, self.contig_end_exclusion)
        total_bases = s.total_bases_window + unobs
        if total_bases == 0:
            return f32(0.0)
        counts = s.hist_trimmed()
        if (
            f32(s.covered_window) / f32(total_bases) < f32(self.min_fraction_covered_bases)
            or total_bases < 3
            or counts.size == 0
        ):
            return f32(0.0)
        counts = counts.copy()
        counts[0] += unobs
        # shifted (sample) variance, estimators.rs:788-809
        k = 0
        clist = counts.tolist()
        while clist[k] == 0:
            k += 1
        ex = 0
        ex2 = 0
        for x, nc in enumerate(clist):
            if nc == 0:
                continue
            ex += (x - k) * nc
            ex2 += (x - k) * (x - k) * nc
        return (f32(ex2) - f32(ex * ex) / f32(total_bases)) / f32(total_bases - 1)

    def calculate_batch(self, b: BatchStats) -> np.ndarray:
        """Shifted variance from moments — no histogram required.

        With counts[0] = window positions not covered, the shift k (first
        non-empty bin, estimators.rs:788-793) is 0 unless the window is
        fully covered, in which case it is the window minimum depth; the
        Σ(x-k)·c / Σ(x-k)²·c sums follow from {Σ1, Σd, Σd²}."""
        unobs = np.asarray(b.unobserved_window_bases)
        total_bases = b.total_bases_window + unobs
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = _f32(b.covered_window) / _f32(total_bases)
        gate = ((total_bases == 0)
                | (frac < f32(self.min_fraction_covered_bases))
                | (total_bases < 3))
        k = np.where(b.covered_window < total_bases, 0, b.min_depth_window)
        S1 = total_bases
        Sx = b.total_count
        Sx2 = b.sumsq_window
        ex = Sx - k * S1
        ex2 = Sx2 - 2 * k * Sx + k * k * S1
        exsq = ex.astype(f64) * ex.astype(f64)  # exact below 2^53
        with np.errstate(divide="ignore", invalid="ignore"):
            out = ((_f32(ex2) - exsq.astype(np.float32) / _f32(total_bases))
                   / _f32(total_bases - 1))
        out[gate] = f32(0.0)
        return out


@dataclass
class LengthEstimator(Estimator):
    headers = ("Length",)

    def calculate(self, s: EntityStats) -> np.float32:
        return f32(s.observed_length_full + sum(s.unobserved_lengths))

    def calculate_batch(self, b: BatchStats) -> np.ndarray:
        return _f32(b.observed_length_full + b.unobserved_full_bases)

    def zero_entry_value(self, entry_length: int):
        return f32(entry_length)


@dataclass
class ReadCountEstimator(Estimator):
    headers = ("Read Count",)

    def calculate(self, s: EntityStats) -> np.float32:
        return f32(s.reads)

    def calculate_batch(self, b: BatchStats) -> np.ndarray:
        return _f32(b.reads)


@dataclass
class ReadsPerBaseEstimator(Estimator):
    headers = ("Reads per base",)

    def calculate(self, s: EntityStats) -> np.float32:
        return f32(s.reads) / f32(
            s.observed_length_full + sum(s.unobserved_lengths))

    def calculate_batch(self, b: BatchStats) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return _f32(b.reads) / _f32(
                b.observed_length_full + b.unobserved_full_bases)


@dataclass
class ANIrEstimator(Estimator):
    headers = ("ANIr",)

    def calculate(self, s: EntityStats) -> np.float32:
        if s.reads == 0:
            return f32(0.0)
        return f32(f64(s.sum_identity) / f64(s.reads))

    def calculate_batch(self, b: BatchStats) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            out = (b.sum_identity.astype(f64)
                   / b.reads.astype(f64)).astype(np.float32)
        out[b.reads == 0] = f32(0.0)
        return out


@dataclass
class StrobealignAembEstimator(Estimator):
    """Passthrough for `-m strobealign-aemb` (strobealign_aemb.rs)."""
    headers = ("Strobealign aemb",)

    def calculate(self, s: EntityStats) -> np.float32:
        raise RuntimeError("strobealign-aemb coverage comes from the mapper output")


def any_needs_hist(estimators) -> bool:
    return any(e.uses_hist for e in estimators)


def any_needs_hist_batch(estimators) -> bool:
    return any(e.uses_hist_batch for e in estimators)
