"""calctruequality: empirical quality recalibration matrices from mapped
SAM, applied by reformat/bbduk recalibrate.

reference: jgi/CalcTrueQuality.java:37 + sh/calctruequality.sh. Observed
error rates are tallied by (claimed quality, read position) from
alignment match strings; recalibrated q = phred of the observed rate
(reference applies via recalibrate=t, CalcTrueQuality.recalibrate:561).
Matrix file format: q \t pos \t count \t errors.
"""

from __future__ import annotations

import re
import sys
from typing import List

import numpy as np

from ..io import fastx
from ..utils.args import Args

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def tally_sam(path: str, maxq: int = 50, maxpos: int = 1024):
    counts = np.zeros((maxq + 1, maxpos), np.int64)
    errors = np.zeros((maxq + 1, maxpos), np.int64)
    n_lines = 0
    with fastx.xopen(path, "rt") as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 11:
                continue
            flag = int(f[1])
            if flag & 0x4 or flag & 0x100 or flag & 0x800:
                continue
            cigar, seq, qual = f[5], f[9], f[10]
            if cigar == "*" or qual == "*":
                continue
            n_lines += 1
            # per-base error mask from =/X cigars (VN1.4 output)
            pos = 0
            for num, op in _CIGAR_RE.findall(cigar):
                num = int(num)
                if op in "=M":
                    for i in range(pos, min(pos + num, maxpos)):
                        q = min(ord(qual[i]) - 33, maxq)
                        counts[q, i] += 1
                    pos += num
                elif op == "X":
                    for i in range(pos, min(pos + num, maxpos)):
                        q = min(ord(qual[i]) - 33, maxq)
                        counts[q, i] += 1
                        errors[q, i] += 1
                    pos += num
                elif op in "IS":
                    pos += num
    return counts, errors, n_lines


def write_matrix(path: str, counts: np.ndarray, errors: np.ndarray):
    with open(path, "w") as fh:
        fh.write("#q\tpos\tcount\terrors\n")
        qs, ps = np.nonzero(counts)
        for q, p in zip(qs, ps):
            fh.write(f"{q}\t{p}\t{counts[q, p]}\t{errors[q, p]}\n")


def load_matrix(path: str, maxq: int = 50, maxpos: int = 1024):
    counts = np.zeros((maxq + 1, maxpos), np.int64)
    errors = np.zeros((maxq + 1, maxpos), np.int64)
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            q, p, c, e = line.split("\t")
            counts[int(q), int(p)] = int(c)
            errors[int(q), int(p)] = int(e)
    return counts, errors


def recalibration_table(counts: np.ndarray, errors: np.ndarray,
                        prior: float = 1.0) -> np.ndarray:
    """(q, pos) -> recalibrated phred, smoothed with the claimed quality
    as a pseudo-count prior."""
    maxq, maxpos = counts.shape
    q_idx = np.arange(maxq)[:, None]
    p_err_claimed = 10.0 ** (-q_idx / 10.0)
    obs = (errors + prior * p_err_claimed) / np.maximum(
        counts + prior, 1e-9)
    obs = np.clip(obs, 1e-5, 0.75)
    return np.clip((-10.0 * np.log10(obs)).round(), 2, maxq).astype(
        np.int8)


def recalibrate_read(qual: np.ndarray, table: np.ndarray) -> np.ndarray:
    pos = np.minimum(np.arange(len(qual)), table.shape[1] - 1)
    q = np.clip(qual, 0, table.shape[0] - 1)
    return table[q, pos]


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    inp = args.get("in", "in1", "sam") or (args.positional[0]
                                           if args.positional else None)
    out = args.get("out", "matrix", default="truequality.txt")
    if inp is None:
        print("Usage: calctruequality in=<mapped.sam> out=<matrix.txt>",
              file=sys.stderr)
        return 1
    counts, errors, n = tally_sam(inp)
    write_matrix(out, counts, errors)
    tot = counts.sum()
    err = errors.sum()
    sys.stderr.write(
        f"Alignments:\t{n}\nBases:\t{tot}\nErrors:\t{err}\n"
        f"Observed error rate:\t{err/max(1,tot):.6f}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
