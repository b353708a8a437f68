"""comparesam: disagreement sets between two SAM files on the same reads.

reference: align2/CompareSamFiles.java:17. Classifies each read name by
(mapped, rname, pos, strand) agreement between two files and prints the
confusion summary; optionally writes disagreeing lines.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

from ..io import fastx
from ..utils.args import Args


def load_primary(path: str) -> Dict[str, Tuple]:
    out = {}
    with fastx.xopen(path, "rt") as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 11:
                continue
            flag = int(f[1])
            if flag & 0x100 or flag & 0x800:
                continue
            key = f[0] + ("/2" if flag & 0x80 else "/1")
            mapped = not (flag & 0x4)
            strand = 1 if flag & 0x10 else 0
            out[key] = (mapped, f[2], int(f[3]), strand, line)
    return out


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1")
    in2 = args.get("in2", "ref")
    out = args.get("out")
    if in1 is None or in2 is None:
        print("Usage: comparesam in1=<a.sam> in2=<b.sam> [out=diff.sam]",
              file=sys.stderr)
        return 1
    a = load_primary(in1)
    b = load_primary(in2)
    same = diff_pos = diff_strand = only_a = only_b = both_unmapped = 0
    a_mapped_b_not = b_mapped_a_not = 0
    diffs: List[str] = []
    for key, va in a.items():
        vb = b.get(key)
        if vb is None:
            only_a += 1
            continue
        if not va[0] and not vb[0]:
            both_unmapped += 1
        elif va[0] and not vb[0]:
            a_mapped_b_not += 1
            diffs.append(va[4])
        elif vb[0] and not va[0]:
            b_mapped_a_not += 1
            diffs.append(vb[4])
        elif va[1] == vb[1] and va[2] == vb[2] and va[3] == vb[3]:
            same += 1
        elif va[1] == vb[1] and va[3] == vb[3]:
            diff_pos += 1
            diffs.append(va[4])
            diffs.append(vb[4])
        else:
            diff_strand += 1
            diffs.append(va[4])
            diffs.append(vb[4])
    for key in b:
        if key not in a:
            only_b += 1
    print(f"Shared reads:        \t{len(a) - only_a}")
    print(f"Identical placement: \t{same}")
    print(f"Different position:  \t{diff_pos}")
    print(f"Different chrom/strand:\t{diff_strand}")
    print(f"Mapped only in 1:    \t{a_mapped_b_not}")
    print(f"Mapped only in 2:    \t{b_mapped_a_not}")
    print(f"Both unmapped:       \t{both_unmapped}")
    print(f"Only in file 1:      \t{only_a}")
    print(f"Only in file 2:      \t{only_b}")
    if out and diffs:
        with fastx.xopen(out, "wt") as fh:
            fh.writelines(diffs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
