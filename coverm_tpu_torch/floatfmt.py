"""Rust-`Display`-compatible float formatting.

CoverM prints coverages with Rust's ``{}`` formatting of ``f32``/``f64``:
the shortest decimal string that round-trips, positional notation (never
scientific), ``0`` for zero, ``NaN``/``inf`` spelled Rust-style.
(reference: coverage_takers.rs:157-167 writes `{coverage}` of an f32).

numpy's `format_float_positional(unique=True)` implements the same
shortest-round-trip (Ryū/Dragon4) contract for the given width.
"""

from __future__ import annotations

import numpy as np


def format_f32(value) -> str:
    """Format a value exactly as Rust formats an ``f32`` with ``{}``."""
    v = np.float32(value)
    if np.isnan(v):
        return "NaN"
    if np.isinf(v):
        return "inf" if v > 0 else "-inf"
    s = np.format_float_positional(v, unique=True, trim="-")
    # numpy prints integral floats as e.g. "1." with trim="-" removing the
    # trailing dot already; defensively strip any trailing '.'
    if s.endswith("."):
        s = s[:-1]
    return s


def format_f64(value) -> str:
    """Format a value exactly as Rust formats an ``f64`` with ``{}``."""
    v = np.float64(value)
    if np.isnan(v):
        return "NaN"
    if np.isinf(v):
        return "inf" if v > 0 else "-inf"
    s = np.format_float_positional(v, unique=True, trim="-")
    if s.endswith("."):
        s = s[:-1]
    return s
