"""callvariants: SNP/indel calling from mapped SAM.

reference: var/ package (GenerateVarlets/StackVariations/Varlet — the
legacy variant pipeline, SURVEY §2.10). Reimplemented as one pileup-based
caller: allele counts accumulate per reference position from =/X/I/D
cigar runs; sites pass with coverage >= mincov and allele fraction >=
minallelefraction. Output: VCF-like TSV (and ApplyVariants support via
tools/applyvariants main mode apply=t).
"""

from __future__ import annotations

import re
import sys
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from ..io import fastx
from ..utils.args import Args

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


class VariantCaller:
    def __init__(self):
        self.sub_counts: Dict[Tuple[str, int, int], int] = defaultdict(int)
        self.ins_counts: Dict[Tuple[str, int, bytes], int] = \
            defaultdict(int)
        self.del_counts: Dict[Tuple[str, int, int], int] = defaultdict(int)
        self.cov: Dict[str, np.ndarray] = {}
        self.lengths: Dict[str, int] = {}

    def add_sq(self, name: str, length: int):
        self.lengths[name] = length
        self.cov[name] = np.zeros(length + 1, np.int32)

    def add_alignment(self, rname: str, pos0: int, cigar: str,
                      seq: str):
        if rname not in self.cov:
            return
        cov = self.cov[rname]
        rp = pos0
        qp = 0
        for num, op in _CIGAR_RE.findall(cigar):
            n = int(num)
            if op in "=M":
                cov[rp:rp + n] += 1
                rp += n
                qp += n
            elif op == "X":
                cov[rp:rp + n] += 1
                for t in range(n):
                    base = seq[qp + t].upper()
                    self.sub_counts[(rname, rp + t,
                                     ord(base))] += 1
                rp += n
                qp += n
            elif op == "I":
                self.ins_counts[(rname, rp,
                                 seq[qp:qp + n].encode())] += 1
                qp += n
            elif op in "DN":
                self.del_counts[(rname, rp, n)] += 1
                rp += n
            elif op == "S":
                qp += n

    def call(self, ref_seqs: Dict[str, bytes], mincov: int = 2,
             min_fraction: float = 0.5):
        rows = []
        for (rname, pos, alt), n in sorted(self.sub_counts.items()):
            c = int(self.cov[rname][pos])
            if c >= mincov and n / max(1, c) >= min_fraction:
                ref_b = chr(ref_seqs[rname][pos]) \
                    if rname in ref_seqs and pos < len(ref_seqs[rname]) \
                    else "N"
                rows.append((rname, pos + 1, "SUB", ref_b, chr(alt), n, c))
        for (rname, pos, ins), n in sorted(self.ins_counts.items()):
            c = int(self.cov[rname][min(pos, len(self.cov[rname]) - 1)])
            if c >= mincov and n / max(1, c) >= min_fraction:
                rows.append((rname, pos + 1, "INS", ".",
                             ins.decode(), n, c))
        for (rname, pos, dlen), n in sorted(self.del_counts.items()):
            c = int(self.cov[rname][pos])
            if c >= mincov and n / max(1, c) >= min_fraction:
                ref_b = ref_seqs.get(rname, b"")[pos:pos + dlen].decode() \
                    if rname in ref_seqs else "." * dlen
                rows.append((rname, pos + 1, "DEL", ref_b, ".", n, c))
        rows.sort(key=lambda r: (r[0], r[1]))
        return rows


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    inp = args.get("in", "in1", "sam") or (args.positional[0]
                                           if args.positional else None)
    ref = args.get("ref")
    out = args.get("out", "vcf", default="vars.txt")
    mincov = args.get_int("mincov", "minreads", default=2)
    min_fraction = args.get_float("minallelefraction", "maf", default=0.5)
    if inp is None:
        print("Usage: callvariants in=<mapped.sam> ref=<ref.fa> "
              "out=<vars.txt>", file=sys.stderr)
        return 1
    vc = VariantCaller()
    with fastx.xopen(inp, "rt") as fh:
        for line in fh:
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    d = dict(f.split(":", 1) for f in
                             line.rstrip("\n").split("\t")[1:])
                    vc.add_sq(d["SN"], int(d["LN"]))
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 11:
                continue
            flag = int(f[1])
            if flag & 0x4 or flag & 0x100 or flag & 0x800:
                continue
            vc.add_alignment(f[2], int(f[3]) - 1, f[5], f[9])
    ref_seqs: Dict[str, bytes] = {}
    if ref:
        for rec in fastx.read_seqs(ref):
            ref_seqs[rec.id] = rec.bases
    rows = vc.call(ref_seqs, mincov, min_fraction)
    with open(out, "w") as fh:
        fh.write("#scaffold\tpos\ttype\tref\talt\tcount\tcoverage\n")
        for r in rows:
            fh.write("\t".join(str(x) for x in r) + "\n")
    sys.stderr.write(f"Variants called:\t{len(rows)}\n")
    return 0


def applyvariants(argv: List[str]) -> int:
    """Apply called variants to a reference
    (reference: var/ApplyVarsToReference.java)."""
    args = Args.parse(argv)
    ref = args.get("ref", "in")
    vars_path = args.get("vars", "vcf")
    out = args.get("out")
    if ref is None or vars_path is None or out is None:
        print("Usage: applyvariants ref= vars= out=", file=sys.stderr)
        return 1
    per_scaf: Dict[str, List[tuple]] = defaultdict(list)
    with open(vars_path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            per_scaf[f[0]].append((int(f[1]) - 1, f[2], f[3], f[4]))

    def gen():
        for rec in fastx.read_seqs(ref):
            seq = bytearray(rec.bases)
            # apply right-to-left so positions stay valid
            for pos, vtype, rb, ab in sorted(per_scaf.get(rec.id, []),
                                             reverse=True):
                if vtype == "SUB" and pos < len(seq):
                    seq[pos] = ord(ab[0])
                elif vtype == "INS":
                    seq[pos:pos] = ab.encode()
                elif vtype == "DEL":
                    del seq[pos:pos + len(rb)]
            yield fastx.SeqRecord(rec.id, bytes(seq), None,
                                  rec.numeric_id)

    fastx.write_fasta(out, gen())
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
