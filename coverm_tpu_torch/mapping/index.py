"""Mapper index management (mapping_index_maintenance.rs).

Builds or locates pre-generated mapper indexes, generates the
concatenated `genome~contig` reference FASTA that makes separator-based
genome recovery possible, and implements `makedb`.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import tempfile

from ..genome_parsing import genome_name_from_path
from ..io.fasta import iter_fasta
from .external import ExternalToolError, check_mapper

BWA_INDEX_SUFFIXES = (".amb", ".ann", ".bwt", ".pac", ".sa")
BWA_MEM2_SUFFIXES = (".0123", ".amb", ".ann", ".bwt.2bit.64", ".pac")


class MappingIndex:
    """index_path() is interpolated into the mapper command; cleanup()
    removes any temporary files."""

    def __init__(self, path):
        self._path = path

    def index_path(self) -> str:
        return self._path

    def command_prefix(self) -> str:
        return ""

    def cleanup(self):
        pass


class PregeneratedStrobealignIndex(MappingIndex):
    """--strobealign-use-index: map against a pre-built .sti index next to
    the reference (mapping_index_maintenance.rs:704-722)."""

    def command_prefix(self) -> str:
        return "--use-index "


class TemporaryIndex(MappingIndex):
    def __init__(self, path, tempdir):
        super().__init__(path)
        self._tempdir = tempdir

    def cleanup(self):
        self._tempdir.cleanup()


def check_reference_existence(reference: str, mapping_program: str):
    if mapping_program.startswith("bwa-mem2"):
        if os.path.exists(reference) or all(
                os.path.exists(reference + s) for s in BWA_MEM2_SUFFIXES):
            return
    elif mapping_program.startswith("bwa") or mapping_program == "minibwa":
        if os.path.exists(reference) or all(
                os.path.exists(reference + s) for s in BWA_INDEX_SUFFIXES):
            return
    elif os.path.exists(reference):
        return
    raise SystemExit(
        f"The reference specified '{reference}' does not appear to exist")


def _has_bwa_index(reference: str, suffixes) -> bool:
    return all(os.path.exists(reference + s) for s in suffixes)


def build_index_command(mapping_program: str, reference: str,
                        output_prefix: str) -> str:
    """Index-construction command per mapper
    (mapping_index_maintenance.rs:80-188)."""
    if mapping_program.startswith("bwa-mem2"):
        return f"bwa-mem2 index -p '{output_prefix}' '{reference}'"
    if mapping_program.startswith("bwa"):
        return f"bwa index -p '{output_prefix}' '{reference}'"
    if mapping_program == "minibwa":
        return f"minibwa index -p '{output_prefix}' '{reference}'"
    if mapping_program.startswith("minimap2"):
        preset = {
            "minimap2-sr": "-x sr ", "minimap2-ont": "-x map-ont ",
            "minimap2-pb": "-x map-pb ", "minimap2-hifi": "-x map-hifi ",
            "minimap2-lr-hq": "-x lr:hq ", "minimap2-no-preset": "",
        }[mapping_program]
        return f"minimap2 {preset}-d '{output_prefix}' '{reference}'"
    if mapping_program == "strobealign":
        return f"strobealign --create-index '{reference}'"
    raise ValueError(f"Cannot build an index for {mapping_program}")


def setup_mapping_index(reference: str, mapping_program: str,
                        reference_is_index=False, threads: int = 1,
                        strobealign_use_index=False,
                        n_readsets: int = 1) -> MappingIndex:
    """setup_mapping_index (coverm.rs:958-1041): use a pre-generated index
    when present, otherwise build a temporary one (BWA-family; minimap2
    when one reference serves several read sets) or map directly against
    the FASTA (strobealign/rammap/single-readset minimap2)."""
    check_reference_existence(reference, mapping_program)
    if mapping_program == "strobealign" and strobealign_use_index:
        logging.warning(
            "Strobealign uses mapping parameters defined when the index was "
            "created, not parameters defined when mapping. Proceeding on the "
            "assumption that you passed the correct parameters when creating "
            "the strobealign index.")
        return PregeneratedStrobealignIndex(reference)
    if mapping_program.startswith("bwa-mem2"):
        if _has_bwa_index(reference, BWA_MEM2_SUFFIXES):
            return MappingIndex(reference)
        return _build_temporary_bwa_index(reference, mapping_program)
    if mapping_program.startswith("bwa") or mapping_program == "minibwa":
        if _has_bwa_index(reference, BWA_INDEX_SUFFIXES):
            return MappingIndex(reference)
        return _build_temporary_bwa_index(reference, mapping_program)
    if mapping_program.startswith("minimap2"):
        # coverm.rs:984-1007: skip pre-indexing when the reference IS a
        # .mmi (--minimap2-reference-is-index) or only one read set maps
        # against it; otherwise pre-generate once and reuse
        if reference_is_index or n_readsets <= 1:
            logging.info("Not pre-generating minimap2 index")
            if reference_is_index:
                logging.warning(
                    "Minimap2 uses mapping parameters defined when the index "
                    "was created, not parameters defined when mapping. "
                    "Proceeding on the assumption that you passed the correct "
                    "parameters when creating the minimap2 index.")
            return MappingIndex(reference)
        return _build_temporary_minimap2_index(reference, mapping_program,
                                               threads)
    # rammap/strobealign map directly against the FASTA
    return MappingIndex(reference)


def _build_temporary_minimap2_index(reference: str, mapping_program: str,
                                    threads: int = 1):
    """generate_minimap2_index (mapping_index_maintenance.rs:190-260)."""
    check_mapper(mapping_program)
    tempdir = tempfile.TemporaryDirectory(prefix="coverm-tpu-minimap2-index")
    out = os.path.join(tempdir.name, os.path.basename(reference) + ".mmi")
    cmd = build_index_command(mapping_program, reference, out)
    cmd = cmd.replace("minimap2 ", f"minimap2 -t {threads} ", 1)
    res = subprocess.run(["bash", "-c", cmd], capture_output=True, text=True)
    if res.returncode != 0:
        raise ExternalToolError(
            f"Index building command '{cmd}' failed: {res.stderr}")
    return TemporaryIndex(out, tempdir)


def _build_temporary_bwa_index(reference: str, mapping_program: str):
    check_mapper(mapping_program)
    tempdir = tempfile.TemporaryDirectory(prefix="coverm-tpu-index")
    prefix = os.path.join(tempdir.name, os.path.basename(reference))
    cmd = build_index_command(mapping_program, reference, prefix)
    res = subprocess.run(["bash", "-c", cmd], capture_output=True, text=True)
    if res.returncode != 0:
        raise ExternalToolError(
            f"Index building command '{cmd}' failed: {res.stderr}")
    return TemporaryIndex(prefix, tempdir)


def generate_concatenated_fasta_file(genome_fasta_paths, output_path=None,
                                     separator="~"):
    """Rename contigs `genome<separator>contig` into one FASTA
    (mapping_index_maintenance.rs:591-702)."""
    if output_path is None:
        fd, output_path = tempfile.mkstemp(prefix="coverm-tpu-concat",
                                           suffix=".fna")
        os.close(fd)
    seen = set()
    with open(output_path, "w") as out:
        for path in genome_fasta_paths:
            genome = genome_name_from_path(path)
            if separator in genome:
                raise SystemExit(
                    f"The separator character '{separator}' was found in the "
                    f"genome name {genome}; this is not allowed")
            for header, seq in iter_fasta(path):
                contig = header.split(" ", 1)[0]
                new_name = f"{genome}{separator}{contig}"
                if new_name in seen:
                    raise SystemExit(
                        f"The contig name {new_name} is duplicated in the "
                        "input genomes")
                seen.add(new_name)
                out.write(f">{new_name}\n{seq}\n")
    return output_path


def mapping_program_db_name(mapping_program: str) -> str:
    """mapping_program_db_name (mapping_index_maintenance.rs:503-522)."""
    base = {
        "bwa-mem": "bwa-mem", "bwa-mem2": "bwa-mem2", "minibwa": "minibwa",
        "strobealign": "strobealign",
    }.get(mapping_program)
    if base is None:
        base = ("minimap2" if mapping_program.startswith("minimap2")
                else "rammap")
    return base + "_db"


def generate_persistent_index(reference: str, mapping_program: str,
                              output_directory: str, threads: int = 1) -> str:
    """makedb: persistent index generation
    (mapping_index_maintenance.rs:528-589)."""
    os.makedirs(output_directory, exist_ok=True)
    db_dir = os.path.join(output_directory,
                          mapping_program_db_name(mapping_program))
    os.makedirs(db_dir, exist_ok=True)
    check_mapper(mapping_program)
    base = os.path.basename(reference)
    if mapping_program.startswith("minimap2") or mapping_program.startswith("rammap"):
        out = os.path.join(db_dir, base + ".mmi")
        cmd = build_index_command(mapping_program, reference, out)
    elif mapping_program == "strobealign":
        # strobealign requires the reference FASTA next to its .sti index
        out = os.path.join(db_dir, base)
        shutil.copyfile(reference, out)
        cmd = f"strobealign --create-index -t {threads} '{out}'"
    else:
        out = os.path.join(db_dir, base)
        cmd = build_index_command(mapping_program, reference, out)
    res = subprocess.run(["bash", "-c", cmd], capture_output=True, text=True)
    if res.returncode != 0:
        raise ExternalToolError(
            f"Index building command '{cmd}' failed: {res.stderr}")
    return out
