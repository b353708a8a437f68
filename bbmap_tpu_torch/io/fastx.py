"""FASTA/FASTQ codecs.

Host-side string handling (design stance: host does strings, device does
math). Replaces the reference's stream-layer format decoders
(reference: stream/FastaReadInputStream.java:23, stream/FastqReadInputStream,
fileIO/ReadWrite.java) with buffered Python/numpy codecs; compression is
handled with the gzip/bz2 modules instead of pigz subprocesses.
"""

from __future__ import annotations

import bz2
import gzip
import io
import os
import sys
from dataclasses import dataclass, field
from typing import IO, Iterator, List, Optional, Tuple

import numpy as np

ASCII_OFFSET = 33  # Sanger phred offset (reference: stream/FASTQ ASCII_OFFSET)


def xopen(path: str, mode: str = "rt") -> IO:
    """Open plain/gzip/bz2 by extension; '-'/'stdin'/'stdout' for stdio
    (reference: fileIO/ReadWrite.java open-by-extension)."""
    if path in ("-", "stdin") or path.startswith("stdin."):
        return sys.stdin.buffer if "b" in mode else sys.stdin
    if path in ("stdout",) or path.startswith("stdout."):
        return sys.stdout.buffer if "b" in mode else sys.stdout
    if path.endswith(".gz") or path.endswith(".gzip"):
        if "w" in mode or "a" in mode:
            # block-parallel compression (pigz-class; reference:
            # fileIO/ReadWrite.java USE_PIGZ :700-780), standard
            # multi-member gzip output
            from .pigz import ParallelGzipWriter, TextParallelGzipWriter
            if "b" in mode:
                return ParallelGzipWriter(path)
            return TextParallelGzipWriter(path)
        return gzip.open(path, mode)
    if path.endswith(".bz2"):
        return bz2.open(path, mode)
    return open(path, mode)


def sniff_format(path: str, data: Optional[bytes] = None) -> str:
    """Detect fasta/fastq/sam by extension, falling back to content
    (reference: fileIO/FileFormat.java)."""
    base = path
    for ext in (".gz", ".gzip", ".bz2"):
        if base.endswith(ext):
            base = base[: -len(ext)]
    ext = os.path.splitext(base)[1].lower()
    if ext in (".fq", ".fastq"):
        return "fastq"
    if ext in (".fa", ".fasta", ".fna", ".ffn", ".frn", ".fas", ".ref"):
        return "fasta"
    if ext == ".sam":
        return "sam"
    if ext == ".bam":
        return "bam"
    if ext == ".scarf":
        return "scarf"
    if data:
        c = data.lstrip()[:1]
        if c == b">":
            return "fasta"
        if c == b"@":
            return "fastq"
    head = None
    try:
        with xopen(path, "rb") as fh:
            head = fh.read(1)
    except Exception:
        pass
    if head == b">":
        return "fasta"
    if head == b"@":
        return "fastq"
    return "unknown"


@dataclass
class SeqRecord:
    """One sequence record; bases/quals as ASCII bytes (quality may be None
    for fasta). Mirrors the essential fields of the reference's Read record
    (reference: stream/Read.java)."""
    id: str
    bases: bytes
    quality: Optional[bytes] = None
    numeric_id: int = 0
    # mate, flags etc. live in the batched representation (core/batch.py)


def read_fastq(path: str) -> Iterator[SeqRecord]:
    """FASTQ reader; uses the native record scanner (csrc/bbio.cpp) when
    available, else the pure-Python line loop."""
    from . import native
    if native.get_lib() is not None:
        yield from _read_fastq_native(path)
        return
    yield from _read_fastq_py(path)


def _read_fastq_native(path: str) -> Iterator[SeqRecord]:
    from . import native
    n = 0
    tail = b""
    with xopen(path, "rb") as fh:
        while True:
            chunk = fh.read(8 << 20)
            if not chunk and not tail:
                return
            buf = tail + chunk
            view = buf
            base = 0
            while True:
                max_recs = max(1024, len(view) // 32)
                res = native.fastq_scan(view[base:], max_recs)
                offs, consumed = res
                for h, hl, s, sl, _, _, q, ql in offs:
                    yield SeqRecord(
                        view[base + h:base + h + hl].decode(),
                        view[base + s:base + s + sl],
                        view[base + q:base + q + ql], n)
                    n += 1
                base += consumed
                if consumed == 0 or len(offs) < max_recs:
                    break
            tail = buf[base:]
            if not chunk:
                if tail.strip():
                    raise ValueError(f"{path}: truncated FASTQ tail")
                return


def _read_fastq_py(path: str) -> Iterator[SeqRecord]:
    n = 0
    with xopen(path, "rb") as fh:
        while True:
            h = fh.readline()
            if not h:
                return
            h = h.strip()
            if not h:
                continue
            if not h.startswith(b"@"):
                raise ValueError(f"{path}: bad fastq header {h[:50]!r}")
            seq = fh.readline().strip()
            plus = fh.readline()
            if not plus.startswith(b"+"):
                raise ValueError(f"{path}: bad fastq separator")
            qual = fh.readline().strip()
            yield SeqRecord(h[1:].decode(), bytes(seq), bytes(qual), n)
            n += 1


def read_fasta(path: str, fake_quality: int = -1) -> Iterator[SeqRecord]:
    n = 0
    name = None
    chunks: List[bytes] = []
    with xopen(path, "rb") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    seq = b"".join(chunks)
                    q = (bytes([fake_quality + ASCII_OFFSET]) * len(seq)
                         if fake_quality >= 0 else None)
                    yield SeqRecord(name, seq, q, n)
                    n += 1
                name = line[1:].decode()
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            seq = b"".join(chunks)
            q = (bytes([fake_quality + ASCII_OFFSET]) * len(seq)
                 if fake_quality >= 0 else None)
            yield SeqRecord(name, seq, q, n)


def read_seqs(path: str, fake_quality: int = -1,
              qual_path: str = None) -> Iterator[SeqRecord]:
    fmt = sniff_format(path)
    if fmt == "fastq":
        return read_fastq(path)
    if fmt == "fasta":
        if qual_path:
            return read_fasta_qual(path, qual_path)
        return read_fasta(path, fake_quality)
    if fmt in ("sam", "bam"):
        return read_sam_seqs(path)
    if fmt == "scarf":
        return read_scarf(path)
    raise ValueError(f"unsupported input format for {path}: {fmt}")


def read_sam_seqs(path: str) -> Iterator[SeqRecord]:
    """SAM/BAM as READ input (reference: stream/SamLine.toRead — minus
    -strand records are reverse-complemented back to original read
    orientation; secondary/supplementary records are skipped)."""
    from . import sam as samio
    from ..core.bases import COMP_ASCII
    import numpy as np
    nid = 0
    for line in samio.open_sam_lines(path):
        if line.startswith("@"):
            continue
        f = line.split("\t")
        if len(f) < 11 or f[9] == "*":
            continue
        flag = int(f[1])
        if flag & (0x100 | 0x800):
            continue
        bases = f[9].encode()
        qual = None if f[10] == "*" else f[10].encode()
        if flag & 0x10:
            arr = np.frombuffer(bases, np.uint8)
            bases = bytes(COMP_ASCII[arr][::-1])
            if qual is not None:
                qual = qual[::-1]
        yield SeqRecord(f[0], bases, qual, nid)
        nid += 1


def read_scarf(path: str) -> Iterator[SeqRecord]:
    """Illumina scarf: colon-separated, sequence and quality are the
    last two fields (reference: stream/ScarfReadInputStream)."""
    nid = 0
    with xopen(path, "rt") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split(":")
            if len(parts) < 3:
                continue
            seq = parts[-2].encode().replace(b".", b"N")
            qual = parts[-1].encode()
            yield SeqRecord(":".join(parts[:-2]), seq,
                            qual if len(qual) == len(seq) else None,
                            nid)
            nid += 1


def read_fasta_qual(path: str, qual_path: str) -> Iterator[SeqRecord]:
    """FASTA + .qual sidecar (reference: qfin= flag,
    stream/FastaQualReadInputStream — qual files hold space-separated
    phred ints under matching '>' headers)."""
    quals = {}
    with xopen(qual_path, "rt") as fh:
        name = None
        vals: list = []
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    quals[name] = vals
                name = line[1:].split()[0]
                vals = []
            elif line:
                vals.extend(int(v) for v in line.split())
        if name is not None:
            quals[name] = vals
    for rec in read_fasta(path, -1):
        key = rec.id.split()[0]
        q = quals.get(key)
        qb = (bytes(min(v, 93) + ASCII_OFFSET for v in q)
              if q is not None and len(q) == len(rec.bases) else None)
        yield SeqRecord(rec.id, rec.bases, qb, rec.numeric_id)


def write_fastq(path: str, records) -> None:
    with xopen(path, "wb") as fh:
        for r in records:
            q = r.quality if r.quality is not None else b"I" * len(r.bases)
            fh.write(b"@" + r.id.encode() + b"\n" + r.bases + b"\n+\n" + q
                     + b"\n")


def write_fasta(path: str, records, wrap: int = 70) -> None:
    with xopen(path, "wb") as fh:
        for r in records:
            fh.write(b">" + r.id.encode() + b"\n")
            if wrap and wrap > 0:
                for i in range(0, len(r.bases), wrap):
                    fh.write(r.bases[i:i + wrap] + b"\n")
            else:
                fh.write(r.bases + b"\n")


class PairedReader:
    """Iterate read pairs from two files or one interleaved file
    (reference: stream/ConcurrentReadInputStream.getReadInputStream paired
    handling)."""

    def __init__(self, in1: str, in2: Optional[str] = None,
                 interleaved: bool = False, qfin: Optional[str] = None,
                 qfin2: Optional[str] = None):
        self.in1, self.in2, self.interleaved = in1, in2, interleaved
        self.qfin, self.qfin2 = qfin, qfin2

    def __iter__(self) -> Iterator[Tuple[SeqRecord, Optional[SeqRecord]]]:
        if self.in2:
            it1 = read_seqs(self.in1, qual_path=self.qfin)
            it2 = read_seqs(self.in2, qual_path=self.qfin2)
            for r1 in it1:
                r2 = next(it2, None)
                if r2 is None:
                    raise ValueError("in2 ended before in1")
                yield r1, r2
            if next(it2, None) is not None:
                raise ValueError("in1 ended before in2")
        elif self.interleaved:
            it = read_seqs(self.in1, qual_path=self.qfin)
            for r1 in it:
                r2 = next(it, None)
                yield r1, r2
        else:
            for r1 in read_seqs(self.in1, qual_path=self.qfin):
                yield r1, None
