"""Contig-name -> genome map (genomes_and_contigs.rs)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class GenomesAndContigs:
    genomes: list = field(default_factory=list)
    contig_to_genome: dict = field(default_factory=dict)

    def establish_genome(self, genome_name: str) -> int:
        self.genomes.append(genome_name)
        return len(self.genomes) - 1

    def genome_index(self, genome_name: str):
        try:
            return self.genomes.index(genome_name)
        except ValueError:
            return None

    def insert(self, contig: str, genome_index: int):
        if contig in self.contig_to_genome:
            raise ValueError(
                f"The contig '{contig}' is associated with multiple genomes")
        self.contig_to_genome[contig] = genome_index

    def genome_index_of_contig(self, contig: str):
        return self.contig_to_genome.get(contig)

    def genome_of_contig(self, contig: str):
        gi = self.contig_to_genome.get(contig)
        return self.genomes[gi] if gi is not None else None
