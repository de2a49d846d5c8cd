"""SAM flag gate (lib.rs:59-79) as a vectorised mask."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .io.bam import RecordBatch


@dataclass
class FlagFilter:
    include_improper_pairs: bool = True
    include_supplementary: bool = True
    include_secondary: bool = False

    def masks(self) -> tuple:
        """(skip_mask, req_mask) for the native fused scan: a record
        passes iff (flag & skip) == 0 and (flag & req) == req —
        equivalent to passes() below."""
        skip = 0
        if not self.include_secondary:
            skip |= 0x100
        if not self.include_supplementary:
            skip |= 0x800
        req = 0 if self.include_improper_pairs else 0x2
        return skip, req

    def passes(self, batch: RecordBatch) -> np.ndarray:
        ok = np.ones(batch.n_records, dtype=bool)
        if not self.include_secondary:
            ok &= ~batch.is_secondary()
        if not self.include_supplementary:
            ok &= ~batch.is_supplementary()
        if not self.include_improper_pairs:
            ok &= batch.is_proper_pair()
        return ok
