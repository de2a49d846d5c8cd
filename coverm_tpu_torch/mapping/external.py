"""External tool presence/version checks (external_command_checker.rs)."""

from __future__ import annotations

import re
import shutil
import subprocess


class ExternalToolError(Exception):
    pass


_MIN_VERSIONS = {
    "minimap2": "2.24",
    "samtools": "1.9",
    "strobealign": "0.11.0",
    "rammap": "1.1.1",
}


def check_for(tool: str):
    if shutil.which(tool.split()[0]) is None:
        raise ExternalToolError(
            f"External tool '{tool}' is required for this operation but was "
            "not found on the PATH")


def _version_of(cmd, args=("--version",)) -> str:
    try:
        out = subprocess.run([cmd, *args], capture_output=True, text=True,
                             timeout=60)
    except Exception as e:
        raise ExternalToolError(f"Failed to run {cmd}: {e}")
    text = out.stdout + out.stderr
    m = re.search(r"(\d+\.\d+(\.\d+)?)", text)
    if not m:
        raise ExternalToolError(f"Could not parse version of {cmd}")
    return m.group(1)


def _version_lt(a: str, b: str) -> bool:
    pa = [int(x) for x in a.split(".")]
    pb = [int(x) for x in b.split(".")]
    return pa < pb


def check_tool_version(tool: str):
    check_for(tool)
    minv = _MIN_VERSIONS.get(tool)
    if minv is None:
        return
    v = _version_of(tool)
    if _version_lt(v, minv):
        raise ExternalToolError(
            f"{tool} version {v} is too old; >= {minv} is required")


def check_for_bwa():
    check_for("bwa")


def check_for_bwa_mem2():
    check_for("bwa-mem2")


def check_for_minibwa():
    check_for("minibwa")


def check_for_minimap2():
    check_tool_version("minimap2")


def check_for_strobealign():
    check_tool_version("strobealign")


def check_for_rammap():
    check_tool_version("rammap")


def check_mapper(mapping_program: str):
    base = mapping_program.split("-")[0]
    if mapping_program.startswith("bwa-mem2"):
        check_for_bwa_mem2()
    elif mapping_program.startswith("bwa"):
        check_for_bwa()
    elif base == "minimap2":
        check_for_minimap2()
    elif base == "strobealign":
        check_for_strobealign()
    elif base == "minibwa":
        check_for_minibwa()
    elif base == "rammap":
        check_for_rammap()
