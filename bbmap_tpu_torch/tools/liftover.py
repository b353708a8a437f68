"""liftover: translate coordinates between genome builds via UCSC
.chain files.

reference: fileIO/ChainBlock.java (chain parsing, :25-90 toLines
segment expansion), fileIO/ChainLine.java:66-84 (binary search +
per-segment affine translate), driver/Translator.java (build-to-build
variant translation driver).

Deviation (documented): for minus-strand chains the reference reports
query positions in the chain's minus-oriented coordinate space and
relies on downstream consumers to flip; here positions are converted to
PLUS-strand coordinates (qSize - 1 - pos), matching the UCSC liftOver
tool's output convention.

Input formats: BED (chrom start end [rest...]) or 2-column positions
(chrom pos). Intervals whose endpoints land in different chains (or in
gaps) go to unmapped= (UCSC semantics).
"""

from __future__ import annotations

import sys
from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

from ..io import fastx
from ..utils.args import Args


class Chains:
    """Per-target-chrom sorted segment table:
    (tStart, tStop, qName, qStrand, qPlusStart) — qPlusStart is the
    PLUS-strand query coordinate of tStart; minus chains step -1."""

    def __init__(self):
        self.segs: Dict[str, List[Tuple[int, int, str, int, int]]] = {}
        self._starts: Dict[str, List[int]] = {}

    def add(self, tname, tstart, tstop, qname, qstrand, qplus0):
        self.segs.setdefault(tname, []).append(
            (tstart, tstop, qname, qstrand, qplus0))

    def finalize(self):
        for tname in self.segs:
            self.segs[tname].sort()
            self._starts[tname] = [s[0] for s in self.segs[tname]]

    def translate(self, chrom: str, pos: int
                  ) -> Optional[Tuple[str, int, int]]:
        """-> (qChrom, qPos_plus, qStrand) or None (reference:
        ChainLine.translate:73-84)."""
        segs = self.segs.get(chrom)
        if not segs:
            return None
        i = bisect_right(self._starts[chrom], pos) - 1
        if i < 0:
            return None
        tstart, tstop, qname, qstrand, qplus0 = segs[i]
        if pos > tstop:
            return None
        off = pos - tstart
        # in PLUS-strand query coordinates both orientations ascend with
        # t (minus chains descend in minus space, reference toLines
        # :77-88, which is ascending after the plus-flip)
        qpos = qplus0 + off
        return qname, qpos, qstrand


def load_chains(path: str) -> Chains:
    """Parse a UCSC .chain file into segment tables (reference:
    ChainBlock ctor :25-57 + toLines :63-90)."""
    ch = Chains()
    with fastx.xopen(path, "rt") as fh:
        head = None
        tloc = qloc = 0
        for line in fh:
            parts = line.split()
            if not parts:
                head = None
                continue
            if parts[0] == "chain":
                # chain score tName tSize tStrand tStart tStop
                #       qName qSize qStrand qStart qStop id
                head = parts
                tloc = int(parts[5])
                q_size = int(parts[8])
                q_minus = parts[9] == "-"
                if not q_minus:
                    qloc = int(parts[10])
                else:
                    # reference iterates qloc downward from qStop-1 in
                    # minus space; convert to plus coords:
                    # plus = qSize - 1 - minus
                    qloc = q_size - 1 - (int(parts[11]) - 1)
                continue
            if head is None:
                continue
            size = int(parts[0])
            q_minus = head[9] == "-"
            tstop = tloc + size - 1
            if not q_minus:
                ch.add(head[2], tloc, tstop, head[7], 0, qloc)
            else:
                # plus-start of the segment descends as minus ascends
                ch.add(head[2], tloc, tstop, head[7], 1, qloc)
            if len(parts) == 3:
                dt, dq = int(parts[1]), int(parts[2])
                tloc = tstop + dt + 1
                qloc = qloc + size + dq   # plus-space: always ascending
            else:
                head = None
    ch.finalize()
    return ch


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    chain = args.get("chain")
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out")
    unmapped = args.get("unmapped")
    if chain is None or in1 is None:
        print("Usage: liftover chain=<file.chain> in=<bed|positions> "
              "out=<file> [unmapped=<file>]", file=sys.stderr)
        return 1
    ch = load_chains(chain)
    n_ok = n_fail = 0
    out_fh = open(out, "w") if out else sys.stdout
    un_fh = open(unmapped, "w") if unmapped else None
    with fastx.xopen(in1, "rt") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith(("#", "track", "browser")):
                continue
            f = line.split("\t")
            if len(f) >= 3 and f[1].isdigit() and f[2].isdigit():
                a = ch.translate(f[0], int(f[1]))
                b = ch.translate(f[0], int(f[2]) - 1)  # BED end excl.
                ok = (a is not None and b is not None
                      and a[0] == b[0] and a[2] == b[2])
                if ok:
                    lo, hi = sorted((a[1], b[1]))
                    out_fh.write("\t".join(
                        [a[0], str(lo), str(hi + 1)] + f[3:]) + "\n")
                    n_ok += 1
                else:
                    n_fail += 1
                    if un_fh:
                        un_fh.write(line + "\n")
            elif len(f) >= 2 and f[1].isdigit():
                a = ch.translate(f[0], int(f[1]))
                if a is not None:
                    out_fh.write(f"{a[0]}\t{a[1]}"
                                 f"\t{'+' if a[2] == 0 else '-'}\n")
                    n_ok += 1
                else:
                    n_fail += 1
                    if un_fh:
                        un_fh.write(line + "\n")
    if out:
        out_fh.close()
    if un_fh:
        un_fh.close()
    sys.stderr.write(f"Lifted:\t{n_ok}\nUnmapped:\t{n_fail}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
