"""Minimal FASTA reading with gz/bz2/xz support (needletail analogue)."""

from __future__ import annotations

import bz2
import gzip
import lzma


def open_maybe_compressed(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    if path.endswith(".bz2") or path.endswith(".bz"):
        return bz2.open(path, "rt")
    if path.endswith(".xz"):
        return lzma.open(path, "rt")
    return open(path, "r")


def iter_fasta(path: str):
    """Yield (header, sequence) tuples; header excludes the '>'."""
    name = None
    seq_parts = []
    with open_maybe_compressed(path) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(seq_parts)
                name = line[1:]
                seq_parts = []
            elif line:
                seq_parts.append(line)
    if name is not None:
        yield name, "".join(seq_parts)
