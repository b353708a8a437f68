"""samtoroc: ROC curve over mapq from truth-encoded SAM.

reference: align2/MakeRocCurve.java:16 + sh/samtoroc.sh. For each mapq
threshold from high to low, counts true/false positives among primary
alignments (truth parsed from RandomReads custom names), printing
cumulative ROC rows.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from ..io import fastx
from ..utils.args import Args
from .gradesam import THRESH2, cigar_spans, parse_custom


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    inp = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    thresh = args.get_int("thresh", default=THRESH2)
    if inp is None:
        print("Usage: samtoroc in=<sam> [thresh=20]", file=sys.stderr)
        return 1
    rows = []  # (mapq, correct)
    total = 0
    from ..io import sam as samio
    for line in samio.open_sam_lines(inp):
        if True:
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 11:
                continue
            flag = int(f[1])
            if flag & 0x100 or flag & 0x800:
                continue
            truth = parse_custom(f[0])
            if truth is None:
                continue
            total += 1
            if flag & 0x4:
                continue
            tchrom, tstrand, tstart, tstop, trel, tname = truth
            strand = 1 if flag & 0x10 else 0
            pos = int(f[3])
            lead, ref_span, trail, _ = cigar_spans(f[5])
            start = pos - 1 - lead
            stop = start + lead + ref_span + trail - 1
            cstop = trel + (tstop - tstart)
            ok = (f[2] == tname and strand == tstrand
                  and (abs(start - trel) <= thresh
                       or abs(stop - cstop) <= thresh))
            rows.append((int(f[4]), ok))
    rows.sort(key=lambda t: -t[0])
    print("#minQuality\tmapped\tretained\ttruePositive\tfalsePositive\t"
          "truePositivePct\tfalsePositivePct")
    tp = fp = 0
    i = 0
    n = len(rows)
    for q in range(50, -1, -1):
        while i < n and rows[i][0] >= q:
            if rows[i][1]:
                tp += 1
            else:
                fp += 1
            i += 1
        print(f"{q}\t{tp+fp}\t{tp+fp}\t{tp}\t{fp}\t"
              f"{100.0*tp/max(1,total):.4f}\t"
              f"{100.0*fp/max(1,total):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
