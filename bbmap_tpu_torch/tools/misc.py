"""Misc utilities: shuffle, partition, translate6frames, kcompress,
bbwrap, bbest-style SAM summary.

reference: jgi/Shuffle.java, jgi/PartitionReads.java,
jgi/TranslateSixFrames.java, assemble/KmerCompressor.java (kcompress.sh),
align2/BBWrap.java.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from ..core.bases import COMP_ASCII
from ..io import fastx
from ..utils.args import Args

CODON = {}
_BASES = "TCAG"
_AA = ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRR"
       "VVVVAAAADDEEGGGG")
for _i, _a in enumerate(_AA):
    _c = _BASES[_i // 16] + _BASES[(_i // 4) % 4] + _BASES[_i % 4]
    CODON[_c] = _a


def shuffle(argv: List[str]) -> int:
    args = Args.parse(argv)
    inp = args.get("in")
    out = args.get("out")
    seed = args.get_int("seed", default=-1)
    if inp is None or out is None:
        print("Usage: shuffle in= out= [seed=]", file=sys.stderr)
        return 1
    recs = list(fastx.read_seqs(inp))
    rng = np.random.default_rng(seed if seed >= 0 else None)
    rng.shuffle(recs)
    if fastx.sniff_format(inp) == "fasta":
        fastx.write_fasta(out, recs)
    else:
        fastx.write_fastq(out, recs)
    return 0


def partition(argv: List[str]) -> int:
    args = Args.parse(argv)
    inp = args.get("in")
    pattern = args.get("out")
    ways = args.get_int("ways", default=2)
    if inp is None or pattern is None or "%" not in pattern:
        print("Usage: partition in= out=part_%.fq ways=N",
              file=sys.stderr)
        return 1
    fhs = [fastx.xopen(pattern.replace("%", str(i)), "wb")
           for i in range(ways)]
    for n, rec in enumerate(fastx.read_seqs(inp)):
        fh = fhs[n % ways]
        q = rec.quality if rec.quality is not None \
            else b"I" * len(rec.bases)
        fh.write(b"@" + rec.id.encode() + b"\n" + rec.bases + b"\n+\n"
                 + q + b"\n")
    for fh in fhs:
        fh.close()
    return 0


def translate6frames(argv: List[str]) -> int:
    """reference: jgi/TranslateSixFrames.java."""
    args = Args.parse(argv)
    inp = args.get("in")
    out = args.get("out")
    frames = args.get_int("frames", default=6)
    if inp is None or out is None:
        print("Usage: translate6frames in= out=aa.fa [frames=6]",
              file=sys.stderr)
        return 1

    def translate(seq: bytes, offset: int) -> str:
        s = seq.decode().upper().replace("U", "T")
        return "".join(CODON.get(s[i:i + 3], "X")
                       for i in range(offset, len(s) - 2, 3))

    def gen():
        for rec in fastx.read_seqs(inp):
            rc = bytes(COMP_ASCII[np.frombuffer(rec.bases,
                                                np.uint8)][::-1])
            for f in range(min(3, frames)):
                yield fastx.SeqRecord(f"{rec.id}_fr{f+1}",
                                      translate(rec.bases, f).encode(),
                                      None, 0)
            if frames > 3:
                for f in range(3):
                    yield fastx.SeqRecord(f"{rec.id}_fr-{f+1}",
                                          translate(rc, f).encode(),
                                          None, 0)

    fastx.write_fasta(out, gen())
    return 0


def kcompress(argv: List[str]) -> int:
    """Assemble the distinct k-mers of the input into compact fasta
    (reference: assemble/KmerCompressor.java + sh/kcompress.sh — used to
    build low-redundancy contaminant references)."""
    from ..core.batch import ReadBatch, batched
    from .kmercountexact import KmerCounter
    from .tadpole import assemble
    args = Args.parse(argv)
    inp = args.get("in")
    out = args.get("out")
    k = args.get_int("k", default=31)
    mincount = args.get_int("min", "mincount", default=1)
    if inp is None or out is None:
        print("Usage: kcompress in= out= k=31 [min=1]", file=sys.stderr)
        return 1
    counter = KmerCounter(k)
    for chunk in batched(fastx.read_seqs(inp), 8192):
        b = ReadBatch.from_records(chunk)
        counter.add_batch(b.bases)
    keys, counts = counter.finish()
    contigs = assemble(keys, counts, k, min_seed=mincount,
                       min_extend=mincount, min_contig=k)
    with fastx.xopen(out, "wt") as fh:
        for i, c in enumerate(contigs):
            fh.write(f">k{i+1}\n{c}\n")
    sys.stderr.write(f"Unique kmers:\t{len(keys)}\n"
                     f"Output contigs:\t{len(contigs)}\n")
    return 0


def bbwrap(argv: List[str]) -> int:
    """Map multiple inputs with one index load
    (reference: align2/BBWrap.java + sh/bbwrap.sh)."""
    from . import bbmap as bbmap_tool
    args = Args.parse(argv)
    ins = (args.get("in", "in1") or "").split(",")
    outs = (args.get("out") or "").split(",")
    if not ins or len(ins) != len(outs):
        print("Usage: bbwrap ref= in=a.fq,b.fq out=a.sam,b.sam ...",
              file=sys.stderr)
        return 1
    base = [a for a in argv
            if not a.lower().startswith(("in=", "in1=", "out="))]
    rc = 0
    for i, o in zip(ins, outs):
        rc |= bbmap_tool.main(base + [f"in={i}", f"out={o}"])
    return rc


def filterbysequence(argv: List[str]) -> int:
    """reference: jgi/FilterBySequence.java — keep or toss reads whose
    full sequence matches a literal in ref= (either orientation when
    rcomp=t); substring mode via contains=t."""
    import numpy as np
    from ..core.bases import COMP_ASCII
    from ..utils.args import Args

    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out", "outm")
    outu = args.get("outu")
    ref = args.get("ref", "literal")
    include = args.get_bool("include", default=False)
    rcomp = args.get_bool("rcomp", "rc", default=True)
    contains = args.get_bool("contains", "substring", default=False)
    case = args.get_bool("casesensitive", "case", default=False)
    if in1 is None or (out is None and outu is None) or ref is None:
        print("Usage: filterbysequence in= out= ref=<fasta|literal,..> "
              "include=f [contains=f rcomp=t]", file=sys.stderr)
        return 1
    lits = []
    import os as _os
    if _os.path.exists(ref):
        for rec in fastx.read_seqs(ref):
            lits.append(rec.bases)
    else:
        lits = [x.encode() for x in ref.split(",")]
    if not case:
        lits = [l.upper() for l in lits]
    if rcomp:
        lits += [bytes(COMP_ASCII[np.frombuffer(l, np.uint8)][::-1])
                 for l in lits]
    lit_set = set(lits)
    fmt = fastx.sniff_format(in1)

    def wr(fh, rec):
        if fh is None:
            return
        if fmt == "fasta":
            fh.write(b">" + rec.id.encode() + b"\n" + rec.bases + b"\n")
        else:
            q = rec.quality if rec.quality is not None \
                else b"I" * len(rec.bases)
            fh.write(b"@" + rec.id.encode() + b"\n" + rec.bases
                     + b"\n+\n" + q + b"\n")

    o = fastx.xopen(out, "wb") if out else None
    ou = fastx.xopen(outu, "wb") if outu else None
    n = kept = 0
    for rec in fastx.read_seqs(in1):
        n += 1
        seq = rec.bases if case else rec.bases.upper()
        if contains:
            hit = any(l in seq for l in lit_set)
        else:
            hit = seq in lit_set
        if hit == include:
            kept += 1
            wr(o, rec)
        else:
            wr(ou, rec)
    for fh in (o, ou):
        if fh is not None:
            fh.close()
    sys.stderr.write(f"Reads:\t{n}\nKept:\t{kept}\n")
    return 0


TOOLS = dict(shuffle=shuffle, partition=partition,
             translate6frames=translate6frames, kcompress=kcompress,
             bbwrap=bbwrap)


def main(argv: List[str]) -> int:
    if not argv or argv[0] not in TOOLS:
        print("misc tools: " + ", ".join(TOOLS), file=sys.stderr)
        return 1
    return TOOLS[argv[0]](argv[1:])
