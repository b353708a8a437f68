"""gradesam: grade a SAM file against truth-encoded read names.

reference: align2/GradeSamFile.java:17 + sh/gradesam.sh. parsecustom mode
decodes the RandomReads name format and classifies each primary alignment
strict/loose correct (reference: isCorrectHit/isCorrectHitLoose:
strand+contig equal, |start-trueStart| and |stop-trueStop| within thresh;
strict thresh=0, loose thresh=THRESH2=20).
"""

from __future__ import annotations

import re
import sys
from typing import List, Optional, Tuple

from ..io import fastx
from ..utils.args import Args

THRESH2 = 20

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def cigar_spans(cigar: str) -> Tuple[int, int, int, int]:
    """(leading clip, ref span, trailing clip, read len incl clips)."""
    if cigar == "*":
        return 0, 0, 0, 0
    ops = _CIGAR_RE.findall(cigar)
    lead = int(ops[0][0]) if ops and ops[0][1] == "S" else 0
    trail = int(ops[-1][0]) if len(ops) > 1 and ops[-1][1] == "S" else 0
    ref = sum(n for n, op in ((int(n), op) for n, op in ops)
              if op in "MDN=X")
    rlen = sum(n for n, op in ((int(n), op) for n, op in ops)
               if op in "MIS=X")
    return lead, ref, trail, rlen


def parse_custom(qname: str):
    """Decode {id}_chr{c}_{strand}_{start}_{stop}_{rel}_{scafname}
    (reference: stream/FASTQ.customID)."""
    parts = qname.split("_")
    if len(parts) < 7 or not parts[1].startswith("chr"):
        return None
    try:
        chrom = int(parts[1][3:])
        strand = int(parts[2])
        start = int(parts[3])
        stop = int(parts[4])
        rel = int(parts[5])
        name = "_".join(parts[6:])
        return chrom, strand, start, stop, rel, name
    except ValueError:
        return None


def grade(sam_path: str, thresh2: int = THRESH2):
    stats = dict(primary=0, mapped=0, strict=0, loose=0,
                 false_positive=0, unmapped=0, unparsed=0)
    from ..io import sam as samio
    for line in samio.open_sam_lines(sam_path):
        if True:
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 11:
                continue
            flag = int(f[1])
            if flag & 0x100 or flag & 0x800:
                continue
            stats["primary"] += 1
            truth = parse_custom(f[0])
            if truth is None:
                stats["unparsed"] += 1
                continue
            tchrom, tstrand, tstart, tstop, trel, tname = truth
            if flag & 0x4:
                stats["unmapped"] += 1
                continue
            stats["mapped"] += 1
            strand = 1 if flag & 0x10 else 0
            pos = int(f[3])
            lead, ref_span, trail, _ = cigar_spans(f[5])
            # reconstruct the unclipped alignment extent, as the reference
            # does when converting SamLine back to a Read
            start = pos - 1 - lead
            stop = start + lead + ref_span + trail - 1
            cstart = trel
            cstop = cstart + (tstop - tstart)
            correct_contig = f[2] == tname
            correct_strand = strand == tstrand
            strict = (correct_contig and correct_strand
                      and abs(start - cstart) <= 0
                      and abs(stop - cstop) <= 0)
            loose = (correct_contig and correct_strand
                     and (abs(start - cstart) <= thresh2
                          or abs(stop - cstop) <= thresh2))
            if strict:
                stats["strict"] += 1
            if loose:
                stats["loose"] += 1
            else:
                stats["false_positive"] += 1
    return stats


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    inp = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    thresh = args.get_int("thresh", default=THRESH2)
    if inp is None:
        print("Usage: gradesam in=<sam> [thresh=20]", file=sys.stderr)
        return 1
    s = grade(inp, thresh)
    n = max(1, s["primary"] - s["unparsed"])
    print(f"Primary alignments:  \t{s['primary']}")
    print(f"Mapped:              \t{s['mapped']}\t"
          f"{100.0*s['mapped']/n:.3f}%")
    print(f"Strictly correct:    \t{s['strict']}\t"
          f"{100.0*s['strict']/n:.3f}%")
    print(f"Loosely correct:     \t{s['loose']}\t"
          f"{100.0*s['loose']/n:.3f}%")
    print(f"False positives:     \t{s['false_positive']}\t"
          f"{100.0*s['false_positive']/n:.3f}%")
    print(f"Unmapped:            \t{s['unmapped']}\t"
          f"{100.0*s['unmapped']/n:.3f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
