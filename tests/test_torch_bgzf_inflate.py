"""The card's BGZF inflate (coverm_tpu_torch/ops/bgzf_inflate.py,
csrc/bgzf_inflate.cu) and the fused ingest's card route
(io/fastscan.scan_sample_fused on a CUDA device), on the CPU.

- The block table the kernel is given: each block's payload offset and
  length and its output offset, held against what Python's zlib decodes,
  on BGZF files written from a numpy seed with zlib levels 0, 1, 6 and 9,
  with Z_FIXED, Z_HUFFMAN_ONLY and Z_RLE, and one whose blocks each hold
  a Huffman-coded block followed by stored blocks, and on streams
  written token by token for the kernel's design (crafted_blocks:
  matches 32,768 back across the history ring's wrap, literal pairs
  whose codes end at the lookup's width, match chains that fill the
  queue at every offset, 64 KiB blocks), each file ending in the empty
  EOF member.
- The kernel's decoder itself: the .cu built for the host by g++, where
  each warp phase runs lane by lane, the copy warp's after the
  decoder's (bgzf_inflate_host), equals zlib on those files at every
  output alignment modulo 16 and flags the corrupt blocks that zlib
  rejects, as does the plain version.
- The card route's pipeline, run on the CPU with the host's
  ct_bgzf_inflate (bgzf_inflate_into) or the plain version in place of
  the kernel: its SampleScan (stats, depth, error messages) equals the
  host route's (ct_ingest_scan) and the JAX package's, on the test BAMs
  of test_torch_scan.py and test_torch_fused_filter.py and a small
  bench_torch/synth.py sample, unfiltered and under -m metabat's filter,
  in segments small enough that records straddle them, with a carry
  longer than the headroom, and on a truncated and a corrupt block.
- Routing: the CPU keeps ct_ingest_scan; a CUDA device never reaches it.

On the card (`python -m pytest --noconftest -m cuda
tests/test_torch_bgzf_inflate.py`), the kernel must equal
ct_bgzf_inflate byte for byte on the same files and flag the corrupt
ones. JAX is
imported only inside the tests that compare with the JAX package.
"""

import ctypes
import gzip
import importlib
import os
import shutil
import struct
import subprocess
import zlib

import numpy as np
import pytest
import torch

from coverm_tpu_torch.flags import FlagFilter
from coverm_tpu_torch.io import fastscan, native
from coverm_tpu_torch.io.bam import BamFormatError
from coverm_tpu_torch.io.fastscan import FusedScanStream, scan_sample_fused
from coverm_tpu_torch.ops import bgzf_inflate as B
from coverm_tpu_torch.ops.depth import ReferenceLayout

EE = 75
SEG = 8192  # fused segment target: records straddle the segments

# (level, strategy) of the adversarial BGZF files
STREAMS = {
    "level0": (0, zlib.Z_DEFAULT_STRATEGY),
    "level1": (1, zlib.Z_DEFAULT_STRATEGY),
    "level6": (6, zlib.Z_DEFAULT_STRATEGY),
    "level9": (9, zlib.Z_DEFAULT_STRATEGY),
    "fixed": (6, zlib.Z_FIXED),
    "huffman_only": (6, zlib.Z_HUFFMAN_ONLY),
    "rle": (6, zlib.Z_RLE),
}
HUFFMAN_THEN_STORED = "huffman_then_stored"
# streams written token by token (deflate_tokens), for the kernel's ring,
# lookup table and match queue
CRAFTED = ("wrap_32k", "pairs_at_width", "queue_chains", "full_64k")
STREAM_NAMES = [*STREAMS, HUFFMAN_THEN_STORED, *CRAFTED]
EOF_MEMBER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def member(raw: bytes, level: int, strategy: int) -> bytes:
    """One BGZF member (gzip header with the BC subfield) of raw, or None
    when it would pass BGZF's 64 KiB."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    body = c.compress(raw) + c.flush()
    if len(body) + 26 > 65536:
        return None
    head = struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                       ord("B"), ord("C"), 2, len(body) + 25)
    return head + body + struct.pack("<II", zlib.crc32(raw), len(raw))


def payloads(seed=0):
    """Block contents that take every DEFLATE path: empty, one byte, long
    runs (overlapping copies, distance 1 and 2, 258-byte matches),
    random bytes (stored or literal-only), DNA-like text with long
    repeats (distances up to 32 KiB), a full 64 KiB block."""
    rng = np.random.default_rng(seed)
    dna = rng.integers(0, 4, 9000, dtype=np.uint8)
    text = b"".join([b"ACGT"[i:i + 1] for i in dna])
    yield b""
    yield b"\x07"
    yield b"A" * 65280
    yield b"xy" * 32640
    yield bytes(rng.integers(0, 256, 65280, dtype=np.uint8))
    yield (text * 8)[:65280]
    yield text[:3000] + bytes(rng.integers(0, 256, 30000, dtype=np.uint8)) \
        + text[:3000]  # a repeat 33,000 bytes back is out of reach
    yield bytes(rng.integers(60, 75, 40000, dtype=np.uint8))
    for n in (2, 3, 31, 257, 259, 4096):
        yield bytes(rng.integers(0, 3, n, dtype=np.uint8))
    yield b"\x00" * 65536  # the largest ISIZE, where it fits a member


def write_bgzf(path, level, strategy, seed=0):
    """A BGZF file of payloads() at (level, strategy), the EOF member
    last; returns the raw blocks (the one that does not fit a BGZF member
    at this level is left out)."""
    raws = []
    with open(path, "wb") as f:
        for raw in payloads(seed):
            m = member(raw, level, strategy)
            if m is None:
                continue
            f.write(m)
            raws.append(raw)
        f.write(EOF_MEMBER)
    return raws + [b""]


def write_huffman_then_stored(path, seed=2):
    """A BGZF file of blocks that each hold a Huffman-coded DEFLATE block
    (DNA text, literals only) and then stored blocks (the empty one of a
    full flush, then 5,000 random bytes); returns the raw blocks. A stored
    block's header is byte-aligned, so the decoder steps back over the
    bytes already pulled into its bit buffer and reads them again. The
    text's length runs over 64 values, about 17 compressed bytes, so the
    Huffman block ends at every offset modulo 16, each time near the end
    of the payload bytes staged so far, with more than 4 KiB to follow."""
    rng = np.random.default_rng(seed)
    text = bytes(np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, 13064)])
    tail = bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
    raws = []
    with open(path, "wb") as f:
        for n in range(13000, 13064):
            c = zlib.compressobj(6, zlib.DEFLATED, -15, 9,
                                 zlib.Z_HUFFMAN_ONLY)
            body = c.compress(text[:n]) + c.flush(zlib.Z_FULL_FLUSH) \
                + c.compress(tail) + c.flush()
            raw = text[:n] + tail
            f.write(struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0,
                                0xFF, 6, ord("B"), ord("C"), 2,
                                len(body) + 25) + body
                    + struct.pack("<II", zlib.crc32(raw), len(raw)))
            raws.append(raw)
        f.write(EOF_MEMBER)
    return raws + [b""]


class BitWriter:
    """DEFLATE's bit order: values from their lowest bit, Huffman codes
    from their highest."""

    def __init__(self):
        self.acc, self.n = 0, 0

    def put(self, value, n):
        self.acc |= value << self.n
        self.n += n

    def code(self, code, n):
        self.put(int(format(code, f"0{n}b")[::-1], 2) if n else 0, n)

    def bytes(self):
        return self.acc.to_bytes((self.n + 7) // 8, "little")


LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
            51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
LEN_EXTRA = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
             385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
             12289, 16385, 24577]
DIST_EXTRA = [0, 0, 0, 0] + [k // 2 for k in range(2, 28)]
FIXED_LIT = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
FIXED_DIST = [5] * 30


def canonical_codes(lengths):
    """Each symbol's canonical code (RFC 1951 §3.2.2)."""
    count = [0] * 16
    for n in lengths:
        count[n] += 1
    count[0] = 0
    code, nxt = 0, [0] * 16
    for n in range(1, 16):
        code = (code + count[n - 1]) << 1
        nxt[n] = code
    codes = []
    for n in lengths:
        codes.append(nxt[n])
        nxt[n] += n > 0
    return codes


def deflate_tokens(tokens, lit_lens=None, dist_lens=None):
    """One final DEFLATE block of `tokens` (a literal byte, an int, or a
    (length, distance) match): fixed Huffman codes when no code lengths
    are given, else a dynamic block with exactly these lengths, each sent
    as its own code-length symbol. Returns (payload, inflated bytes)."""
    w = BitWriter()
    out = bytearray()
    dynamic = lit_lens is not None
    lit_lens = lit_lens or FIXED_LIT
    dist_lens = dist_lens or FIXED_DIST
    w.put(1, 1)
    w.put(2 if dynamic else 1, 2)
    if dynamic:
        w.put(len(lit_lens) - 257, 5)
        w.put(len(dist_lens) - 1, 5)
        w.put(19 - 4, 4)
        # the code-length code: 13 symbols of 4 bits, 6 of 5 (complete)
        cl_lens = [4] * 13 + [5] * 6
        order = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14,
                 1, 15]
        by_sym = [0] * 19
        for rank, sym in enumerate(sorted(range(19),
                                          key=lambda x: (x > 15, x))):
            by_sym[sym] = cl_lens[rank]
        for sym in order:
            w.put(by_sym[sym], 3)
        cl_codes = canonical_codes(by_sym)
        for n in list(lit_lens) + list(dist_lens):
            w.code(cl_codes[n], by_sym[n])
    lc, dc = canonical_codes(lit_lens), canonical_codes(dist_lens)
    for t in tokens:
        if isinstance(t, int):
            w.code(lc[t], lit_lens[t])
            out.append(t)
            continue
        length, dist = t
        sym = max(i for i, b in enumerate(LEN_BASE) if b <= length)
        if length == 258:
            sym = 28
        w.code(lc[257 + sym], lit_lens[257 + sym])
        w.put(length - LEN_BASE[sym], LEN_EXTRA[sym])
        ds = max(i for i, b in enumerate(DIST_BASE) if b <= dist)
        w.code(dc[ds], dist_lens[ds])
        w.put(dist - DIST_BASE[ds], DIST_EXTRA[ds])
        for _ in range(length):
            out.append(out[-dist])
    w.code(lc[256], lit_lens[256])
    return w.bytes(), bytes(out)


def crafted_blocks(name, seed=3):
    """(payload, raw) blocks of a crafted stream:
    - wrap_32k: 33,000 random literals, then matches at distances 32,768,
      32,767 and 32,700 that reach back across the 32 KiB history ring's
      wrap (lengths 3 to 258), literals between, to 65,536 bytes;
    - pairs_at_width: a dynamic block whose literals 'A'-'K' have codes of
      1 to 11 bits (the end of block and one length code 12), every
      ordered pair of them in turn: pairs of codes that end before, at
      and past the 11-bit lookup;
    - queue_chains: runs of 40-200 back-to-back matches, each reading the
      one before it (distances 1-12 into bytes a queued match writes),
      after 0-40 literals, so the 32-match queue fills at every offset;
    - full_64k: blocks of exactly 65,536 bytes (DNA text with repeats and
      random runs), Huffman-coded by zlib, for the flush at every output
      alignment."""
    rng = np.random.default_rng(seed)
    if name == "wrap_32k":
        for run in range(3):
            toks = [int(b) for b in rng.integers(0, 256, 33000)]
            n = 33000
            while n < 65536 - 300:
                dist = int(rng.choice([32768, 32767, 32700]))
                length = int(rng.choice([3, 4, 31, 32, 33, 100, 257, 258]))
                toks.append((length, dist))
                n += length
                for _ in range(int(rng.integers(0, 3 + run))):
                    toks.append(int(rng.integers(0, 256)))
                    n += 1
            while n < 65536:
                toks.append(int(rng.integers(0, 256)))
                n += 1
            yield deflate_tokens(toks)
    elif name == "pairs_at_width":
        lit = [0] * 286
        for i in range(11):
            lit[65 + i] = i + 1
        lit[256] = lit[257] = 12
        syms = range(65, 76)
        toks = [a for x in syms for y in syms for a in (x, y)]
        toks += [(3, 1)] + [65, 75] * 20  # the 12-bit length code
        yield deflate_tokens(toks, lit, [1])
        yield deflate_tokens(toks[1:] * 3, lit, [1])
    elif name == "queue_chains":
        toks, n = [], 0
        while n < 60000:
            for _ in range(int(rng.integers(0, 41))):
                toks.append(int(rng.integers(0, 256)))
                n += 1
            if n < 12:
                continue
            for _ in range(int(rng.integers(40, 201))):
                length = int(rng.integers(3, 20))
                toks.append((length, int(rng.integers(1, 13))))
                n += length
        yield deflate_tokens(toks)
    else:
        text = bytes(np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, 20000)])
        for k in range(4):
            raw = (text[k * 100:] + bytes(rng.integers(0, 256, 3000,
                                                       dtype=np.uint8))
                   + text) * 3
            c = zlib.compressobj(1 + 2 * k, zlib.DEFLATED, -15)
            yield c.compress(raw[:65536]) + c.flush(), raw[:65536]


def write_crafted(path, name):
    """A BGZF file of crafted_blocks(name), the EOF member last; returns
    the raw blocks."""
    raws = []
    with open(path, "wb") as f:
        for body, raw in crafted_blocks(name):
            assert zlib.decompress(body, -15) == raw  # zlib agrees
            f.write(struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0,
                                0xFF, 6, ord("B"), ord("C"), 2,
                                len(body) + 25) + body
                    + struct.pack("<II", zlib.crc32(raw), len(raw)))
            raws.append(raw)
        f.write(EOF_MEMBER)
    return raws + [b""]


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    d = tmp_path_factory.mktemp("bgzf")
    out = {}
    for name, (level, strategy) in STREAMS.items():
        path = str(d / f"{name}.gz")
        out[name] = (path, write_bgzf(path, level, strategy))
    path = str(d / f"{HUFFMAN_THEN_STORED}.gz")
    out[HUFFMAN_THEN_STORED] = (path, write_huffman_then_stored(path))
    for name in CRAFTED:
        path = str(d / f"{name}.gz")
        out[name] = (path, write_crafted(path, name))
    return out


def table_of(path):
    """(file bytes padded for the kernel's loads, block table, ISIZEs)."""
    data = np.fromfile(path, np.uint8)
    off, csz, usz = native.bgzf_scan(data)
    comp = np.concatenate([data, np.zeros(B.PAD, np.uint8)])
    return comp, B.block_table(comp, off, csz, usz), usz


@pytest.mark.parametrize("name", STREAM_NAMES)
def test_block_table_equals_what_zlib_decodes(streams, name):
    path, raws = streams[name]
    comp, table, usz = table_of(path)
    assert table.shape == (len(raws), 4)
    assert table[-1, 3] == 0  # the EOF member
    whole = b""
    for (p, n, at, size), raw in zip(table.tolist(), raws):
        d = zlib.decompressobj(-15)
        got = d.decompress(comp[p:p + n].tobytes())
        assert d.eof and not d.unused_data  # the payload ends the stream
        assert got == raw and size == len(raw) and at == len(whole)
        # the 8-byte trailer follows: CRC32 then ISIZE
        assert struct.unpack_from("<II", comp, p + n) == (
            zlib.crc32(raw), len(raw))
        whole += got
    with gzip.open(path, "rb") as f:
        assert f.read() == whole


def test_block_table_of_a_segment(streams):
    """A segment's table is relative to its staging buffer, which starts
    at the segment's first block."""
    path, raws = streams["level6"]
    data = np.fromfile(path, np.uint8)
    off, csz, usz = native.bgzf_scan(data)
    i, k = 3, 9
    comp = data[off[i]:off[k - 1] + csz[k - 1]]
    table = B.block_table(comp, off[i:k] - off[i], csz[i:k], usz[i:k])
    out = b"".join(zlib.decompress(comp[p:p + n].tobytes(), -15)
                   for p, n, _, _ in table.tolist())
    assert out == b"".join(raws[i:k])
    assert table[0, 2] == 0 and table[-1, 2] + table[-1, 3] == len(out)


def _plain(comp, table, out_size):
    out = torch.zeros(out_size, dtype=torch.uint8)
    status = torch.full((table.shape[0],), -1, dtype=torch.int32)
    B.bgzf_inflate(torch.from_numpy(comp), torch.from_numpy(table), out,
                   status, "cpu")
    return out.numpy(), status.numpy()


@pytest.mark.parametrize("name", STREAM_NAMES)
def test_plain_version_equals_zlib(streams, name):
    path, raws = streams[name]
    comp, table, usz = table_of(path)
    launches = B.bgzf_inflate_launches
    out, status = _plain(comp, table, int(usz.sum()))
    assert B.bgzf_inflate_launches == launches  # the plain version
    assert not status.any()
    assert out.tobytes() == b"".join(raws)


@pytest.fixture(scope="module")
def host_decoder(tmp_path_factory):
    """The kernel's source built for the host by g++ (bgzf_inflate_host)."""
    cxx = shutil.which("g++")
    assert cxx, "g++ builds the native library; it must be here"
    lib = str(tmp_path_factory.mktemp("host") / "libbgzf_host.so")
    subprocess.run([cxx, "-O2", "-std=c++17", "-x", "c++", "-shared",
                    "-fPIC", "-o", lib, B.SOURCE], check=True,
                   capture_output=True, timeout=300)
    so = ctypes.CDLL(lib)
    so.bgzf_inflate_host.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong]

    def run(comp, table, out_size, shift=0):
        out = np.zeros(out_size + 32, np.uint8)
        status = np.full(table.shape[0], -1, np.int32)
        so.bgzf_inflate_host(comp.ctypes.data, table.ctypes.data,
                             out.ctypes.data + shift, status.ctypes.data,
                             table.shape[0])
        return out[shift:shift + out_size], status
    return run


@pytest.mark.parametrize("shift", range(16))
@pytest.mark.parametrize("name", STREAM_NAMES)
def test_kernel_decoder_equals_zlib(streams, host_decoder, name, shift):
    """The kernel's decode and its streamed 16-byte flush, at every output
    alignment modulo 16."""
    path, raws = streams[name]
    comp, table, usz = table_of(path)
    out, status = host_decoder(comp, table, int(usz.sum()), shift)
    assert not status.any()
    assert out.tobytes() == b"".join(raws)


def corrupt_cases(seed=1):
    """(label, member bytes, ISIZE given) of blocks every inflate must
    reject: an invalid block type, a distance before the start, a payload
    cut short, an ISIZE one more or one less than the data, an ISIZE over
    BGZF's 65,536, and random bit flips (checked against zlib's verdict
    by the caller)."""
    rng = np.random.default_rng(seed)
    raw = bytes(rng.integers(0, 4, 20000, dtype=np.uint8) + 65)
    good = member(raw, 6, zlib.Z_DEFAULT_STRATEGY)
    bad_type = bytearray(good)
    bad_type[18] |= 0x06  # BTYPE 11
    yield "block type 3", bytes(bad_type), len(raw)
    # fixed Huffman: literal 'A', then length 3 at distance 2 (> 1 byte
    # out), then end of block; each code's bits go most significant first
    def code(value, n):
        return [(value >> (n - 1 - i)) & 1 for i in range(n)]
    bits = [1, 1, 0] + code(0x30 + ord("A"), 8) + code(1, 7) + code(1, 5) \
        + code(0, 7)
    acc = sum(b << i for i, b in enumerate(bits))
    body = acc.to_bytes((len(bits) + 7) // 8, "little")
    far = struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                      ord("B"), ord("C"), 2, len(body) + 25) + body + \
        struct.pack("<II", 0, 4)
    yield "distance too far back", far, 4
    m = member(raw, 6, zlib.Z_DEFAULT_STRATEGY)
    body = m[18:-8]
    cut = body[:len(body) // 2]
    yield "payload cut short", struct.pack(
        "<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, ord("B"),
        ord("C"), 2, len(cut) + 25) + cut + m[-8:], len(raw)
    yield "ISIZE one more", good, len(raw) + 1
    yield "ISIZE one less", good, len(raw) - 1
    yield "ISIZE over 65536", member(b"\x00" * 70000, 9, 0), 70000
    for k in range(40):
        flipped = bytearray(good)
        for _ in range(3):
            i = int(rng.integers(18, len(good) - 8))
            flipped[i] ^= 1 << int(rng.integers(0, 8))
        yield f"bit flips {k}", bytes(flipped), len(raw)


def zlib_rejects(m, size):
    d = zlib.decompressobj(-15)
    try:
        got = d.decompress(m[18:-8], size + 1)
    except zlib.error:
        return True
    return not d.eof or len(got) != size or size > B.MAX_BLOCK


def _one_block(m, size):
    comp = np.frombuffer(m + bytes(B.PAD), np.uint8).copy()
    table = B.block_table(comp, np.array([0]), np.array([len(m)]),
                          np.array([size]))
    return comp, table


def test_corrupt_blocks_are_flagged(host_decoder):
    """The kernel's decoder and the plain version flag exactly the blocks
    zlib rejects, the named corruptions among them; the other blocks
    inflate to zlib's bytes."""
    n_bad = 0
    for label, m, size in corrupt_cases():
        comp, table = _one_block(m, size)
        want_bad = zlib_rejects(m, size)
        if not label.startswith("bit flips"):
            assert want_bad, label
        n_bad += want_bad
        got, status = host_decoder(comp, table, max(size, 0))
        plain, plain_status = _plain(comp, table, max(size, 0))
        assert bool(status[0]) == want_bad == bool(plain_status[0]), label
        if not want_bad:
            assert got.tobytes() == plain.tobytes(), label
    assert n_bad > 10


def test_wrapper_takes_pinned_tensors_on_a_card():
    """A CUDA device takes the kernel, never the plain version: unpinned
    tensors are refused."""
    comp, table = _one_block(EOF_MEMBER, 0)
    with pytest.raises(ValueError, match="pinned"):
        B.bgzf_inflate(torch.from_numpy(comp.copy()),
                       torch.from_numpy(table), torch.zeros(1, dtype=torch.uint8),
                       torch.zeros(1, dtype=torch.int32), "cuda")


def test_inflate_ab_tells_segments_apart(tmp_path):
    """scripts/inflate_ab.py's segment kinds on a demo-shaped sample whose
    unmapped reads follow its mapped ones: the plan's segments, inflated
    on the host, are mapped, then mixed, then unmapped."""
    from bench_torch import synth
    from coverm_tpu_torch.scripts import inflate_ab
    bam = str(tmp_path / "demo.bam")
    synth.write_bam(bam, synth.demo(40_000, 8, 20_000, seed=1))
    with pytest.MonkeyPatch.context() as m:
        m.setenv("COVERM_TPU_SEGMENT_BYTES", str(1 << 20))
        mm, off, csz, usz, segments = inflate_ab.segments_of(bam)
    kinds = [inflate_ab.kind(native.bgzf_inflate_blocks(
        mm, off[i:k], csz[i:k], usz[i:k]).tobytes()) for i, k in segments]
    assert kinds[0] == "mapped" and kinds[-1] == "unmapped"
    assert kinds.count("mixed") <= 1
    assert kinds == sorted(kinds, key=["mapped", "mixed",
                                       "unmapped"].index)


def test_inflate_ab_needs_a_card(capsys):
    from coverm_tpu_torch.scripts import inflate_ab
    assert inflate_ab.main(["x.bam"]) == 2
    assert "needs an NVIDIA card" in capsys.readouterr().err


# ---- the card route's pipeline on the CPU

def host_inflate_injected(comp, table, out, status, device):
    """The kernel's stand-in: the host's ct_bgzf_inflate over the same
    blocks (BGZF members with XLEN 6 start 18 bytes before their
    payload)."""
    t = table.numpy()
    c = comp.numpy()
    assert (c[t[:, 0] - 8] == 6).all()  # XLEN
    ok = native.bgzf_inflate_into(c, t[:, 0] - 18, t[:, 1] + 26, t[:, 3],
                                  out.numpy(), 0)
    status.fill_(0 if ok else B.BAD_CODE)


@pytest.fixture(params=["host_inflate", "plain_version"])
def card_route(request, monkeypatch):
    """scan_sample_fused's card route on the CPU: the segments through
    SegmentInflater, its kernel replaced by the host's inflate or by the
    plain version."""
    made = []

    def inflater(dev):
        def make(path, off, csz, usz, segments, at):
            inf = B.SegmentInflater(path, off, csz, usz, segments, at, "cpu")
            made.append(inf)
            return inf
        return make
    monkeypatch.setattr(fastscan, "_card_inflater", inflater)
    if request.param == "host_inflate":
        monkeypatch.setattr(B, "bgzf_inflate", host_inflate_injected)
    return made


def outcome(path, read_filter=None, ff=None):
    """SampleScan of the fused scan on the CPU, or (error class, message)."""
    ff = ff or FlagFilter()
    stream = FusedScanStream(path)
    header = stream.open()
    assert stream._plan is not None
    if read_filter is not None:
        class Source:
            num_primary_override = None
        stream = stream.filtered(Source(), read_filter, ff)
    layout = ReferenceLayout.build(header.target_lens, EE)
    try:
        return scan_sample_fused(header, stream, layout, ff, True,
                                 trim=(0.1, 0.9), device="cpu")
    except Exception as e:
        return type(e).__name__, str(e)


def host_outcome(path, monkeypatch, **kw):
    with monkeypatch.context() as m:
        m.setattr(fastscan, "_card_inflater", lambda dev: None)
        return outcome(path, **kw)


def assert_same(got, want):
    if isinstance(want, tuple):
        assert got == want
        return
    assert not isinstance(got, tuple), got
    _tests_module("test_torch_scan").assert_scans_equal(got, want, hist=True)


def _tests_module(name):
    """A sibling test module (they import the JAX package, so not at the
    top of this one, whose cuda case runs where JAX is absent)."""
    return importlib.import_module(name)


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("bams")
    scan_mod = _tests_module("test_torch_scan")
    filt_mod = _tests_module("test_torch_fused_filter")
    from bench_torch import synth
    demo = str(d / "demo.bam")
    synth.write_bam(demo, synth.demo(30_000, 8, 20_000, seed=3))
    return {
        "mixed": scan_mod.write_bam(str(d / "mixed.bam")),
        "filter_cases": filt_mod.write_bam(str(d / "filter.bam")),
        "demo": demo,
    }


def _metabat():
    return _tests_module("test_torch_fused_filter").METABAT


@pytest.mark.parametrize("segment_bytes", [SEG, None])
@pytest.mark.parametrize("name", ["mixed", "filter_cases", "demo"])
def test_card_route_equals_host_route(bams, card_route, monkeypatch, name,
                                      segment_bytes):
    if segment_bytes:
        monkeypatch.setenv("COVERM_TPU_SEGMENT_BYTES", str(segment_bytes))
    want = host_outcome(bams[name], monkeypatch)
    got = outcome(bams[name])
    assert card_route and all(not inf._pending for inf in card_route)
    assert all(inf.stage_s > 0 and inf.wait_s > 0 for inf in card_route)
    assert_same(got, want)


@pytest.mark.parametrize("name", ["filter_cases", "demo"])
def test_card_route_under_metabat_filter(bams, card_route, monkeypatch,
                                         name):
    monkeypatch.setenv("COVERM_TPU_SEGMENT_BYTES", str(SEG))
    params, ff = _metabat()
    want = host_outcome(bams[name], monkeypatch, read_filter=params, ff=ff)
    got = outcome(bams[name], read_filter=params, ff=ff)
    assert card_route
    assert_same(got, want)


def test_card_route_carry_longer_than_headroom(bams, card_route,
                                               monkeypatch):
    """A 16-byte headroom in the card slot: every straddling record's
    carry is longer, so the slot grows to hold it."""
    monkeypatch.setenv("COVERM_TPU_SEGMENT_BYTES", str(SEG))
    want = host_outcome(bams["mixed"], monkeypatch)
    monkeypatch.setattr(fastscan, "_CARD_HEADROOM", 16)
    got = outcome(bams["mixed"])
    assert_same(got, want)


def test_card_route_equals_the_jax_package(bams, card_route, monkeypatch):
    """The slice as a whole: the card route's SampleScan equals the JAX
    package's fused scan over the same segments."""
    _tests_module("test_torch_native_build").load_jax_native()
    from coverm_tpu.flags import FlagFilter as JFlagFilter
    from coverm_tpu.io.fastscan import FusedScanStream as JFused
    from coverm_tpu.io.fastscan import scan_sample_fused as j_scan_fused
    from coverm_tpu.ops.depth import ReferenceLayout as JLayout
    monkeypatch.setenv("COVERM_TPU_SEGMENT_BYTES", str(SEG))
    path = bams["mixed"]
    js = JFused(path)
    jh = js.open()
    want = j_scan_fused(jh, js, JLayout.build(jh.target_lens, EE),
                        JFlagFilter(), True, trim=(0.1, 0.9))
    assert_same(outcome(path), want)


def _damaged(src, dst, how):
    """A copy of the BAM at src whose 5th block from the end is corrupt
    (BTYPE 3) or cut short (its payload halved, BSIZE rewritten)."""
    data = np.fromfile(src, np.uint8)
    off, csz, usz = native.bgzf_scan(data)
    b = off.size - 5
    m = bytearray(data[off[b]:off[b] + csz[b]].tobytes())
    if how == "corrupt":
        m[18] |= 0x06
    else:
        body = m[18:-8][:(len(m) - 26) // 2]
        m = m[:16] + struct.pack("<H", len(body) + 25) + body + m[-8:]
    with open(dst, "wb") as f:
        f.write(data[:off[b]].tobytes() + bytes(m)
                + data[off[b] + csz[b]:].tobytes())
    return dst


@pytest.mark.parametrize("how", ["corrupt", "truncated"])
def test_card_route_raises_as_host_route(bams, card_route, monkeypatch,
                                         tmp_path, how):
    monkeypatch.setenv("COVERM_TPU_SEGMENT_BYTES", str(SEG))
    path = _damaged(bams["mixed"], str(tmp_path / f"{how}.bam"), how)
    want = host_outcome(path, monkeypatch)
    assert want == (BamFormatError.__name__, B.FAILED)
    assert outcome(path) == want
    assert card_route and all(not inf._pending for inf in card_route)


def test_cpu_keeps_the_host_ingest(bams, monkeypatch):
    """device="cpu" inflates and scans with ct_ingest_scan and builds no
    SegmentInflater."""
    calls = []
    orig = native.ingest_scan

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    def no_card(*a, **k):
        raise AssertionError("the CPU built a SegmentInflater")
    monkeypatch.setenv("COVERM_TPU_SEGMENT_BYTES", str(SEG))
    monkeypatch.setattr(native, "ingest_scan", counted)
    monkeypatch.setattr(B, "SegmentInflater", no_card)
    assert not isinstance(outcome(bams["mixed"]), tuple)
    assert len(calls) > 1


def test_cuda_never_reaches_the_host_ingest(bams, monkeypatch):
    """On a CUDA device (None resolves to one) the segments go through
    SegmentInflater on that device, never ct_ingest_scan; here the card
    is stood in for by the plain version."""
    from coverm_tpu_torch import device as D
    from coverm_tpu_torch.ops.sweep import _EmptyPending
    card = torch.device("cuda", 0)
    devices = []

    class StandIn(B.SegmentInflater):
        def __init__(self, *a):
            devices.append(a[-1])
            super().__init__(*a[:-1], "cpu")

    def refused(*a, **k):
        raise AssertionError("a CUDA device reached ct_ingest_scan")
    def stubbed(device):
        stream = FusedScanStream(bams["mixed"])
        header = stream.open()
        layout = ReferenceLayout.build(header.target_lens, EE)
        blocks = []

        def stub(layout, bt, *a, **kw):
            blocks.append(bt.size)
            return _EmptyPending(layout.n_contigs,
                                 kw.get("need_hist", False), kw.get("trim"))
        scan = scan_sample_fused(header, stream, layout, FlagFilter(), False,
                                 device=device, depth_fn=stub)
        return scan, sum(blocks)
    monkeypatch.setenv("COVERM_TPU_SEGMENT_BYTES", str(SEG))
    want, want_blocks = stubbed("cpu")
    monkeypatch.setattr(D, "resolve_device",
                        lambda d=None: card if d is None else torch.device(d))
    monkeypatch.setattr(native, "ingest_scan", refused)
    monkeypatch.setattr(B, "SegmentInflater", StandIn)
    got, blocks = stubbed(None)
    assert devices == [card]
    assert blocks == want_blocks > 0
    for f in ("reads_primary", "reads_all", "nm_sum", "observed"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


# ---- on the card

@pytest.mark.cuda
def test_cuda_kernel_equals_host_inflate(streams, tmp_path):
    """The kernel, byte for byte, against ct_bgzf_inflate on every
    adversarial and crafted file and on a bench-shaped BAM, at an
    unaligned output (the 64 KiB blocks at every alignment), the corrupt
    blocks flagged, and inflate_ab's two launches of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from coverm_tpu_torch.synth import write_sorted_bam
    bam = str(tmp_path / "bench.bam")
    write_sorted_bam(bam, n_contigs=4, contig_len=200_000)
    dev = torch.device("cuda")

    def on_card(comp, table, out_size, shift=3):
        pin = lambda a: torch.from_numpy(a).pin_memory()  # noqa: E731
        out = torch.zeros(out_size + 16, dtype=torch.uint8).pin_memory()
        status = torch.full((table.shape[0],), -1,
                            dtype=torch.int32).pin_memory()
        launches = B.bgzf_inflate_launches
        # an empty out has no address: the kernel writes nothing then
        B.bgzf_inflate(pin(comp), pin(table), out[shift:shift + out_size],
                       status, dev)
        torch.cuda.synchronize()
        assert B.bgzf_inflate_launches == launches + 1
        return out.numpy()[shift:shift + out_size], status.numpy()

    eof_only = str(tmp_path / "eof.gz")
    with open(eof_only, "wb") as f:
        f.write(EOF_MEMBER)  # a table whose outputs are all empty
    for path in [p for p, _ in streams.values()] + [bam, eof_only]:
        comp, table, usz = table_of(path)
        data = np.fromfile(path, np.uint8)
        off, csz, _ = native.bgzf_scan(data)
        want = native.bgzf_inflate_blocks(data, off, csz, usz)
        # the 64 KiB blocks at every alignment
        for shift in range(16) if path == streams["full_64k"][0] else (3,):
            got, status = on_card(comp, table, int(usz.sum()), shift)
            assert not status.any(), (path, shift)
            assert got.tobytes() == want.tobytes(), (path, shift)
    for label, m, size in corrupt_cases():
        comp, table = _one_block(m, size)
        got, status = on_card(comp, table, max(size, 0))
        assert bool(status[0]) == zlib_rejects(m, size), label
    # scripts/inflate_ab.py's launches, the card named without an index
    # as chip_smoke.py names it (each launch checked there)
    from coverm_tpu_torch.scripts import inflate_ab
    record = inflate_ab.run_bam(
        bam, inflate_ab.launchers(["kernel", "kernel@card"]), dev)
    assert set(record["variants"]) == {"kernel", "kernel@card"}
