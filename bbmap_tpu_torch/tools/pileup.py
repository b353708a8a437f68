"""pileup: coverage statistics from a SAM file.

reference: jgi/CoveragePileup.java:37 + sh/pileup.sh (also run inline by
bbmap covstats/basecov flags, align2/BBMap.java:408-418). Computes
per-scaffold coverage (covstats), per-base coverage (basecov), binned
coverage (bincov), and a coverage histogram (covhist) in one pass using
numpy diff-array accumulation.
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Optional

import numpy as np

from ..io import fastx
from ..utils.args import Args

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


class CoveragePileup:
    def __init__(self):
        self.lengths: Dict[str, int] = {}
        self.deltas: Dict[str, np.ndarray] = {}
        self.read_counts: Dict[str, int] = {}
        self.base_counts: Dict[str, int] = {}
        self.n_records = 0
        self.n_mapped = 0

    def add_header_sq(self, name: str, length: int):
        self.lengths[name] = length
        self.deltas[name] = np.zeros(length + 1, np.int64)
        self.read_counts[name] = 0
        self.base_counts[name] = 0

    def add_sam_line(self, fields: List[str]):
        self.n_records += 1
        flag = int(fields[1])
        if flag & 0x4 or flag & 0x100 or flag & 0x800:
            return
        rname = fields[2]
        if rname == "*" or rname not in self.deltas:
            return
        self.n_mapped += 1
        pos = int(fields[3]) - 1
        # ref span from cigar
        span = 0
        covered = 0
        for n, op in _CIGAR_RE.findall(fields[5]):
            if op in "MDN=X":
                span += int(n)
            if op in "M=X":
                covered += int(n)
        if span == 0:
            span = len(fields[9])
            covered = span
        L = self.lengths[rname]
        a = max(0, pos)
        b = min(L, pos + span)
        if b > a:
            self.deltas[rname][a] += 1
            self.deltas[rname][b] -= 1
        self.read_counts[rname] += 1
        self.base_counts[rname] += covered

    def coverage(self, name: str) -> np.ndarray:
        return np.cumsum(self.deltas[name][:-1])

    def covstats(self):
        rows = []
        for name, L in self.lengths.items():
            cov = self.coverage(name)
            covered = int((cov > 0).sum())
            avg = float(cov.mean()) if L else 0.0
            std = float(cov.std()) if L else 0.0
            rows.append(dict(name=name, avg_fold=avg, length=L,
                             covered_bases=covered,
                             covered_percent=100.0 * covered / max(1, L),
                             plus_reads=self.read_counts[name],
                             std=std,
                             median=int(np.median(cov)) if L else 0))
        return rows


def process_sam(path: str) -> CoveragePileup:
    cp = CoveragePileup()
    from ..io import sam as samio
    for line in samio.open_sam_lines(path):
        if True:
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    d = dict(f.split(":", 1) for f in
                             line.rstrip("\n").split("\t")[1:])
                    cp.add_header_sq(d["SN"], int(d["LN"]))
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) >= 11:
                cp.add_sam_line(f)
    return cp


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    inp = args.get("in") or (args.positional[0] if args.positional
                             else None)
    out = args.get("out", "covstats", "stats")
    basecov = args.get("basecov")
    bincov = args.get("bincov")
    binsize = args.get_int("binsize", default=1000)
    covhist = args.get("covhist", "hist")
    if inp is None:
        print("Usage: pileup in=<sam> out=<covstats.txt> "
              "[basecov=] [bincov=] [covhist=]", file=sys.stderr)
        return 1
    cp = process_sam(inp)
    rows = cp.covstats()
    if out:
        with fastx.xopen(out, "wt") as fh:
            fh.write("#ID\tAvg_fold\tLength\tCovered_percent\t"
                     "Covered_bases\tPlus_reads\tMedian_fold\tStd_Dev\n")
            for r in rows:
                fh.write(f"{r['name']}\t{r['avg_fold']:.4f}\t"
                         f"{r['length']}\t{r['covered_percent']:.4f}\t"
                         f"{r['covered_bases']}\t{r['plus_reads']}\t"
                         f"{r['median']}\t{r['std']:.2f}\n")
    if basecov:
        with fastx.xopen(basecov, "wt") as fh:
            fh.write("#RefName\tPos\tCoverage\n")
            for name in cp.lengths:
                cov = cp.coverage(name)
                for i, v in enumerate(cov):
                    fh.write(f"{name}\t{i}\t{v}\n")
    if bincov:
        with fastx.xopen(bincov, "wt") as fh:
            fh.write("#RefName\tCov\tPos\tRunningPos\n")
            running = 0
            for name in cp.lengths:
                cov = cp.coverage(name)
                for i in range(0, len(cov), binsize):
                    seg = cov[i:i + binsize]
                    fh.write(f"{name}\t{seg.mean():.2f}\t{i}\t{running}\n")
                    running += len(seg)
    if covhist:
        allcov = np.concatenate([cp.coverage(n) for n in cp.lengths]) \
            if cp.lengths else np.zeros(0, np.int64)
        hist = np.bincount(allcov) if len(allcov) else np.zeros(1, int)
        with fastx.xopen(covhist, "wt") as fh:
            fh.write("#Coverage\tnumBases\n")
            for d in range(len(hist)):
                if hist[d]:
                    fh.write(f"{d}\t{hist[d]}\n")
    avg = (sum(r["avg_fold"] * r["length"] for r in rows)
           / max(1, sum(r["length"] for r in rows)))
    sys.stderr.write(f"Records:\t{cp.n_records}\nMapped:\t{cp.n_mapped}\n"
                     f"Average coverage:\t{avg:.3f}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
