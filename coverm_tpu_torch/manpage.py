"""Man-page generation from the argparse definitions.

The reference generates roff manuals from its clap definitions
(cli.rs:401-1366 via bird_tool_utils_man) and exposes them as
`--full-help` (rendered) and `--full-help-roff` (raw roff).  Here the
same two flags render the argparse subparser, so the help content can
never drift from the real CLI surface.
"""

from __future__ import annotations

import argparse
import datetime

from . import __version__


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace("-", "\\-")


def _actions(parser):
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            continue
        yield a


def _invocation(a) -> str:
    if not a.option_strings:
        return a.dest.upper()
    parts = list(a.option_strings)
    if a.nargs != 0 and not isinstance(
            a, (argparse._StoreTrueAction, argparse._VersionAction,
                argparse._HelpAction)):
        metavar = a.metavar or a.dest.upper().replace("-", "_")
        parts[-1] += f" <{metavar}>"
    return ", ".join(parts)


def render_roff(parser, subcommand: str) -> str:
    """Raw roff man page for one subcommand (--full-help-roff)."""
    date = datetime.date.today().strftime("%Y-%m-%d")
    desc = parser.description or ""
    lines = [
        f'.TH "COVERM-TPU {subcommand.upper()}" "1" "{date}" '
        f'"coverm-tpu {__version__}" "User Commands"',
        ".SH NAME",
        f"coverm-tpu {_esc(subcommand)} \\- {_esc(desc)}",
        ".SH SYNOPSIS",
        f".B coverm-tpu {_esc(subcommand)}",
        "[\\fIOPTIONS\\fR]",
        ".SH DESCRIPTION",
        _esc(desc),
        ".SH OPTIONS",
    ]
    for a in _actions(parser):
        lines.append(".TP")
        lines.append(f"\\fB{_esc(_invocation(a))}\\fR")
        text = (a.help or "").replace("%%", "%")
        if (a.default not in (None, False, argparse.SUPPRESS)
                and not isinstance(a, (argparse._HelpAction,
                                       argparse._VersionAction))):
            text += f" [default: {a.default}]"
        if getattr(a, "choices", None):
            text += " (choices: " + ", ".join(map(str, a.choices)) + ")"
        lines.append(_esc(text) if text else "\\ ")
    for title, cmd in getattr(parser, "_manpage_examples", []):
        lines += [".SH EXAMPLES" if ".SH EXAMPLES" not in lines else ".PP",
                  _esc(title) + ":", ".PP", ".nf",
                  "  " + _esc(cmd), ".fi"]
    faq = getattr(parser, "_manpage_faq", None)
    if faq:
        lines += [".SH FREQUENTLY ASKED QUESTIONS", _esc(faq)]
    lines += [
        ".SH AUTHORS",
        "coverm-tpu contributors",
        ".SH SEE ALSO",
        "The CoverM reference implementation this engine is "
        "capability\\-compatible with.",
    ]
    return "\n".join(lines) + "\n"


def render_text(parser, subcommand: str) -> str:
    """Rendered full help for one subcommand (--full-help)."""
    desc = parser.description or ""
    out = [f"coverm-tpu {subcommand} - {desc}", "",
           f"USAGE: coverm-tpu {subcommand} [OPTIONS]", "", "OPTIONS:"]
    for a in _actions(parser):
        head = "  " + _invocation(a)
        text = (a.help or "").replace("%%", "%")
        if (a.default not in (None, False, argparse.SUPPRESS)
                and not isinstance(a, (argparse._HelpAction,
                                       argparse._VersionAction))):
            text += f" [default: {a.default}]"
        if getattr(a, "choices", None):
            text += " (choices: " + ", ".join(map(str, a.choices)) + ")"
        out.append(head)
        if text:
            out.append("        " + text)
        out.append("")
    examples = getattr(parser, "_manpage_examples", [])
    if examples:
        out.append("EXAMPLES:")
        for title, cmd in examples:
            out += ["  " + title + ":", "        " + cmd, ""]
    faq = getattr(parser, "_manpage_faq", None)
    if faq:
        out += ["FREQUENTLY ASKED QUESTIONS:", "  " + faq, ""]
    return "\n".join(out)
