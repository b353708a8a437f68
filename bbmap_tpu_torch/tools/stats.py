"""stats: assembly statistics (N50/L50/GC/gaps), single pass.

reference: jgi/AssemblyStats2.java + sh/stats.sh.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from ..io import fastx
from ..utils.args import Args


def contig_breaks(seq: np.ndarray, min_gap: int = 1) -> List[int]:
    """Split a scaffold into contigs at runs of >= min_gap Ns."""
    is_n = seq == ord("N")
    if not is_n.any():
        return [len(seq)]
    lengths = []
    run = 0
    gap = 0
    for v in is_n:
        if v:
            gap += 1
            if gap == min_gap and run > 0:
                lengths.append(run)
                run = 0
        else:
            if gap < min_gap:
                run += gap
            gap = 0
            run += 1
    if run > 0:
        lengths.append(run)
    return lengths


def nx_lx(lengths: List[int], total: int, frac: float):
    target = total * frac
    acc = 0
    for i, ln in enumerate(sorted(lengths, reverse=True), 1):
        acc += ln
        if acc >= target:
            return ln, i
    return 0, 0


def compute_stats(path: str, gc_per_scaffold: bool = False):
    scaf_lengths: List[int] = []
    contig_lengths: List[int] = []
    counts = np.zeros(256, np.int64)
    per_scaffold = []
    for rec in fastx.read_fasta(path):
        seq = np.frombuffer(rec.bases, np.uint8)
        up = seq.copy()
        lo = (up >= ord("a")) & (up <= ord("z"))
        up[lo] -= 32
        scaf_lengths.append(len(seq))
        contig_lengths.extend(contig_breaks(up, min_gap=10))
        c = np.bincount(up, minlength=256)
        counts += c
        if gc_per_scaffold:
            acgt = sum(int(c[ord(x)]) for x in "ACGT")
            gc = (int(c[ord("G")]) + int(c[ord("C")])) / max(1, acgt)
            per_scaffold.append((rec.id, len(seq), gc))
    total = sum(scaf_lengths)
    ctotal = sum(contig_lengths)
    a, g, cc, t = (int(counts[ord(x)]) for x in "AGCT")
    n = int(counts[ord("N")])
    acgt = a + g + cc + t
    out = {
        "scaffolds": len(scaf_lengths),
        "contigs": len(contig_lengths),
        "scaf_bases": total,
        "contig_bases": ctotal,
        "gap_bases": total - ctotal,
        "gc": (g + cc) / max(1, acgt),
        "n_frac": n / max(1, total),
        "max_scaf": max(scaf_lengths, default=0),
        "max_contig": max(contig_lengths, default=0),
        "per_scaffold": per_scaffold,
    }
    for frac, name in ((0.5, "50"), (0.9, "90")):
        nx, lx = nx_lx(scaf_lengths, total, frac)
        out[f"scaf_n{name}"], out[f"scaf_l{name}"] = nx, lx
        nxc, lxc = nx_lx(contig_lengths, ctotal, frac)
        out[f"contig_n{name}"], out[f"contig_l{name}"] = nxc, lxc
    return out


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    inp = args.get("in") or (args.positional[0] if args.positional
                             else None)
    if inp is None:
        print("Usage: stats in=<assembly.fa>", file=sys.stderr)
        return 1
    s = compute_stats(inp, gc_per_scaffold=args.has("gc"))
    print(f"Main genome scaffold total:         \t{s['scaffolds']}")
    print(f"Main genome contig total:           \t{s['contigs']}")
    print(f"Main genome scaffold sequence total:\t{s['scaf_bases']}")
    print(f"Main genome contig sequence total:  \t{s['contig_bases']}\t"
          f"({100.0*s['gap_bases']/max(1,s['scaf_bases']):.3f}% gap)")
    print(f"Main genome scaffold N/L50:         \t"
          f"{s['scaf_l50']}/{s['scaf_n50']}")
    print(f"Main genome contig N/L50:           \t"
          f"{s['contig_l50']}/{s['contig_n50']}")
    print(f"Main genome scaffold N/L90:         \t"
          f"{s['scaf_l90']}/{s['scaf_n90']}")
    print(f"Main genome contig N/L90:           \t"
          f"{s['contig_l90']}/{s['contig_n90']}")
    print(f"Max scaffold length:                \t{s['max_scaf']}")
    print(f"Max contig length:                  \t{s['max_contig']}")
    print(f"GC content:                         \t{100.0*s['gc']:.2f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
