"""Read-input normalisation (mapping_parameters.rs): turn the CLI's read
flags into per-(reference, readset) mapping jobs."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum


class ReadFormat(Enum):
    COUPLED = "coupled"
    INTERLEAVED = "interleaved"
    SINGLE = "single"


LONG_READ_PRESETS = {
    "minimap2-ont", "minimap2-pb", "minimap2-hifi", "minimap2-lr-hq",
    "rammap-ont", "rammap-pb", "rammap-hifi", "rammap-lr-hq",
}


@dataclass
class OneSampleMappingParameters:
    reference: str
    read1: str
    read2: str | None
    read_format: ReadFormat
    threads: int
    mapping_options: str | None


@dataclass
class MappingParameters:
    """Per-reference lists of read sets (mapping_parameters.rs:29-170)."""

    references: list = field(default_factory=list)  # list[(ref, [jobs])]

    @staticmethod
    def generate_from_args(args, references) -> "MappingParameters":
        mapper = args.mapper
        read1 = args.read1 or []
        read2 = args.read2 or []
        interleaved = args.interleaved or []
        single = args.single or []
        coupled = args.coupled or []

        if (read1 and not read2) or (read2 and not read1):
            raise SystemExit(
                "When specifying paired reads with the -1 and -2 flags, "
                "both flags must be set")
        if len(read1) != len(read2):
            raise SystemExit(
                f"When specifying paired reads with the -1 and -2 flags, the "
                f"same number of reads must be given to both flags "
                f"(found {len(read1)} and {len(read2)})")
        if coupled and len(coupled) % 2 != 0:
            raise SystemExit(
                "The --coupled flag must be set with an even number of reads")

        if mapper in LONG_READ_PRESETS and (read1 or coupled or interleaved):
            raise SystemExit(
                f"Paired-end or interleaved read input cannot be used with "
                f"the long-read mapping preset {mapper}; provide unpaired "
                "reads with --single")
        if mapper == "minibwa" and interleaved:
            raise SystemExit(
                "minibwa does not support interleaved read input")

        mapping_options = None
        if mapper.startswith("minimap2") or mapper.startswith("rammap"):
            mapping_options = args.minimap2_params if mapper.startswith(
                "minimap2") else args.rammap_params
        elif mapper == "minibwa":
            mapping_options = getattr(args, "minibwa_params", None)
        elif mapper.startswith("bwa"):
            mapping_options = args.bwa_params
        elif mapper == "strobealign":
            mapping_options = args.strobealign_params

        threads = args.threads
        out = MappingParameters()
        for ref in references:
            jobs = []
            for r1, r2 in zip(read1, read2):
                jobs.append(OneSampleMappingParameters(
                    ref, r1, r2, ReadFormat.COUPLED, threads, mapping_options))
            i = 0
            while i < len(coupled):
                jobs.append(OneSampleMappingParameters(
                    ref, coupled[i], coupled[i + 1], ReadFormat.COUPLED,
                    threads, mapping_options))
                i += 2
            for r in interleaved:
                jobs.append(OneSampleMappingParameters(
                    ref, r, None, ReadFormat.INTERLEAVED, threads,
                    mapping_options))
            for r in single:
                jobs.append(OneSampleMappingParameters(
                    ref, r, None, ReadFormat.SINGLE, threads, mapping_options))
            out.references.append((ref, jobs))
        return out
