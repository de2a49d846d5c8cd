"""Build GenomesAndContigs from FASTA files or a definition file
(genome_parsing.rs)."""

from __future__ import annotations

import os

from .genomes_and_contigs import GenomesAndContigs
from .io.fasta import iter_fasta


def genome_name_from_path(path: str) -> str:
    """File stem after stripping .gz/.bz/.xz (genome_parsing.rs:22-40)."""
    name = path
    for ext in (".gz", ".bz", ".xz"):
        i = name.rfind(ext)
        if i != -1:
            name = name[:i]
            break
    stem = os.path.basename(name)
    dot = stem.rfind(".")
    if dot > 0:
        stem = stem[:dot]
    return stem


def read_genome_fasta_files(paths, use_full_contig_names=False) -> GenomesAndContigs:
    gc = GenomesAndContigs()
    for path in paths:
        genome_name = genome_name_from_path(path)
        if gc.genome_index(genome_name) is not None:
            raise ValueError(
                f"The genome name {genome_name} was derived from >1 file")
        gi = gc.establish_genome(genome_name)
        for header, _seq in iter_fasta(path):
            contig = header if use_full_contig_names else header.split(" ", 1)[0]
            gc.insert(contig, gi)
    return gc


def read_genome_definition_file(path: str) -> GenomesAndContigs:
    contig_to_genome = {}
    genome_to_contig = {}
    genome_order = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            v = line.split("\t")
            if len(v) == 2:
                genome = v[0].strip()
                parts = v[1].split()
                if not parts:
                    raise ValueError(
                        "Failed to split contig name by whitespace in genome "
                        "definition file")
                contig = parts[0]
                if contig in contig_to_genome:
                    if contig_to_genome[contig] != genome:
                        raise ValueError(
                            f"The contig name '{contig}' was assigned to "
                            "multiple genomes")
                else:
                    contig_to_genome[contig] = genome
                    if genome not in genome_to_contig:
                        genome_to_contig[genome] = []
                        genome_order.append(genome)
                    genome_to_contig[genome].append(contig)
            elif line == "":
                continue
            else:
                raise ValueError(
                    f'The line "{line}" in the genome definition file is not '
                    "a genome name and contig name separated by a tab")
    gc = GenomesAndContigs()
    for genome in genome_order:
        gi = gc.establish_genome(genome)
        for contig in genome_to_contig[genome]:
            gc.insert(contig, gi)
    return gc
