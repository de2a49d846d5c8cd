"""SAM text -> BAM byte-stream encoding.

The mapper subprocess pipeline consumes SAM on the mapper's stdout
(bam_generator.rs pipes it through `samtools sort` into a FIFO; here
sorting happens inside the engine, so samtools is not needed at all).
SAM lines are encoded into uncompressed-BAM record bytes and fed through
the same vectorised record parser as real BAM files, so every downstream
component (filters, writers, qname access) behaves identically.
"""

from __future__ import annotations

import re
import struct

import numpy as np

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")
_CIGAR_OPS = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6,
              "=": 7, "X": 8}
_SEQ_NYB = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def encode_sam_record(fields, name_to_tid) -> bytes:
    """Encode one SAM record (list of fields) as a BAM record (with the
    leading block_size u32)."""
    qname = fields[0]
    flag = int(fields[1])
    rname = fields[2]
    pos = int(fields[3]) - 1
    mapq = int(fields[4])
    cigar = fields[5]
    rnext = fields[6]
    pnext = int(fields[7]) - 1
    tlen = int(fields[8])
    seq = fields[9]
    qual = fields[10]

    tid = name_to_tid.get(rname, -1)
    if rnext == "=":
        ntid = tid
    else:
        ntid = name_to_tid.get(rnext, -1)

    cig_ops = [] if cigar == "*" else _CIGAR_RE.findall(cigar)
    l_seq = 0 if seq == "*" else len(seq)
    name_b = qname.encode() + b"\x00"

    out = bytearray()
    out += struct.pack("<iiBBHHHiiii", tid, pos, len(name_b), mapq,
                       4680, len(cig_ops), flag, l_seq, ntid, pnext, tlen)
    out += name_b
    for ln, op in cig_ops:
        out += struct.pack("<I", (int(ln) << 4) | _CIGAR_OPS[op])
    if l_seq:
        nyb = [_SEQ_NYB.get(c.upper(), 15) for c in seq]
        if len(nyb) % 2:
            nyb.append(0)
        out += bytes((nyb[i] << 4) | nyb[i + 1] for i in range(0, len(nyb), 2))
        if qual == "*":
            out += b"\xff" * l_seq
        else:
            out += bytes((min(ord(c) - 33, 255) for c in qual))
    # aux tags
    for tag in fields[11:]:
        parts = tag.split(":", 2)
        if len(parts) != 3:
            continue
        name, typ, value = parts
        tb = name.encode()[:2]
        if typ == "i":
            out += tb + b"i" + struct.pack("<i", int(value))
        elif typ == "A":
            out += tb + b"A" + value[:1].encode()
        elif typ == "f":
            out += tb + b"f" + struct.pack("<f", float(value))
        elif typ in ("Z", "H"):
            out += tb + typ.encode() + value.encode() + b"\x00"
        elif typ == "B":
            sub = value[0]
            vals = value.split(",")[1:]
            fmtmap = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i",
                      "I": "I", "f": "f"}
            conv = float if sub == "f" else int
            out += tb + b"B" + sub.encode() + struct.pack("<I", len(vals))
            for v in vals:
                out += struct.pack("<" + fmtmap[sub], conv(v))
    return struct.pack("<I", len(out)) + bytes(out)


def sam_text_to_bam_data(lines_iter):
    """Convert an iterator of SAM lines into uncompressed BAM bytes
    (header block + records)."""
    header_lines = []
    names = []
    lens = []
    records = bytearray()
    name_to_tid = {}
    for line in lines_iter:
        if isinstance(line, bytes):
            line = line.decode()
        line = line.rstrip("\n").rstrip("\r")
        if not line:
            continue
        if line.startswith("@"):
            header_lines.append(line)
            if line.startswith("@SQ"):
                sn, ln = None, None
                for f in line.split("\t")[1:]:
                    if f.startswith("SN:"):
                        sn = f[3:]
                    elif f.startswith("LN:"):
                        ln = int(f[3:])
                if sn is not None and ln is not None:
                    name_to_tid[sn] = len(names)
                    names.append(sn)
                    lens.append(ln)
            continue
        fields = line.split("\t")
        records += encode_sam_record(fields, name_to_tid)

    text = ("\n".join(header_lines) + "\n").encode() if header_lines else b""
    out = bytearray()
    out += b"BAM\x01"
    out += struct.pack("<i", len(text))
    out += text
    out += struct.pack("<i", len(names))
    for n, l in zip(names, lens):
        nb = n.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<I", l)
    out += records
    return bytes(out)


def _bam_header_bytes(header_lines, names, lens) -> bytes:
    text = ("\n".join(header_lines) + "\n").encode() if header_lines else b""
    out = bytearray()
    out += b"BAM\x01"
    out += struct.pack("<i", len(text))
    out += text
    out += struct.pack("<i", len(names))
    for n, l in zip(names, lens):
        nb = n.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<I", l)
    return bytes(out)
