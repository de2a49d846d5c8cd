"""Genome exclusion during desharding (genome_exclusion.rs)."""

from __future__ import annotations


class GenomeExclusion:
    def is_excluded(self, contig_name: str) -> bool:
        raise NotImplementedError


class NoExclusionGenomeFilter(GenomeExclusion):
    def is_excluded(self, contig_name: str) -> bool:
        return False


class SeparatorGenomeExclusionFilter(GenomeExclusion):
    def __init__(self, excluded_genomes, separator="~"):
        self.excluded = set(excluded_genomes)
        self.separator = separator

    def is_excluded(self, contig_name: str) -> bool:
        if self.separator not in contig_name:
            # genome_exclusion.rs:53-55 panics here
            raise ValueError(
                f"Contig name {contig_name} does not contain split symbol, "
                "so cannot determine which genome it belongs to")
        genome = contig_name.split(self.separator, 1)[0]
        return genome in self.excluded


class GenomesAndContigsExclusionFilter(GenomeExclusion):
    """Exclude contigs whose genome (via the contig->genome map) is in the
    excluded set (genome_exclusion.rs:18-39)."""

    def __init__(self, genomes_and_contigs, excluded_genomes):
        self.gc = genomes_and_contigs
        self.excluded = set(excluded_genomes)

    def is_excluded(self, contig_name: str) -> bool:
        gi = self.gc.genome_index_of_contig(contig_name)
        if gi is None:
            return False
        return self.gc.genomes[gi] in self.excluded
