"""bbmask: mask low-entropy (and optionally repeat) regions with N.

reference: jgi/BBMask.java:45 + sh/bbmask.sh. Covers entropy-window
masking (default window=80, k=5, entropy<0.70 masked) and lowercase
masking; sam-coverage masking via sam= (mask positions covered by mapped reads).
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from ..core.bases import BASE_TO_NUMBER
from ..io import fastx
from ..utils.args import Args


def window_entropy_mask(seq: np.ndarray, window: int = 80, k: int = 5,
                        threshold: float = 0.70) -> np.ndarray:
    """Boolean mask of positions inside low-entropy windows.
    Entropy is Shannon entropy of the k-mer distribution within each
    window, normalized by log(window) (reference: BBMask entropy mode)."""
    L = len(seq)
    if L < window:
        return np.zeros(L, bool)
    codes = BASE_TO_NUMBER[seq].astype(np.int64)
    valid = codes >= 0
    m = L - k + 1
    kmers = np.zeros(m, np.int64)
    kvalid = np.ones(m, bool)
    for j in range(k):
        kmers = (kmers << 2) | (codes[j:m + j] & 3)
        kvalid &= valid[j:m + j]
    nwin = L - window + 1
    mask = np.zeros(L, bool)
    wk = window - k + 1  # kmers per window
    # rolling entropy via incremental counts
    counts = np.zeros(4 ** k, np.int32)
    lowwins = []
    ent_cache = {}

    def entropy_of(c):
        nz = c[c > 0]
        p = nz / nz.sum()
        return float(-(p * np.log(p)).sum() / np.log(min(wk, 4 ** k)))

    for key in kmers[:wk][kvalid[:wk]]:
        counts[key] += 1
    if entropy_of(counts) < threshold:
        lowwins.append(0)
    for w in range(1, nwin):
        old, new = w - 1, w + wk - 1
        if kvalid[old]:
            counts[kmers[old]] -= 1
        if new < m and kvalid[new]:
            counts[kmers[new]] += 1
        if entropy_of(counts) < threshold:
            lowwins.append(w)
    for w in lowwins:
        mask[w:w + window] = True
    return mask


_CIGAR_RE = None


def _sam_refspan(cigar: str) -> int:
    global _CIGAR_RE
    if _CIGAR_RE is None:
        import re
        _CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")
    return sum(int(n) for n, op in _CIGAR_RE.findall(cigar)
               if op in "MDN=X")


def sam_coverage_masks(sam_paths: List[str], scaffolds: dict,
                       mincov: int = 1) -> dict:
    """Per-scaffold boolean masks of positions covered by >= mincov
    mapped sam records (reference: jgi/BBMask.java sam= input —
    masking a reference by read coverage, sh/bbmask.sh sam= flag)."""
    cov = {name: np.zeros(ln, np.int32)
           for name, ln in scaffolds.items()}
    for path in sam_paths:
        with fastx.xopen(path, "rt") as fh:
            for line in fh:
                if line.startswith("@"):
                    continue
                f = line.rstrip("\n").split("\t")
                if len(f) < 6 or int(f[1]) & 0x4:
                    continue
                rname, pos, cigar = f[2], int(f[3]) - 1, f[5]
                if rname not in cov or cigar == "*":
                    continue
                span = _sam_refspan(cigar)
                c = cov[rname]
                a = max(0, pos)
                b = min(len(c), pos + span)
                if b > a:
                    c[a:b] += 1
    return {name: c >= mincov for name, c in cov.items()}


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out")
    window = args.get_int("window", "w", default=80)
    k = args.get_int("k", "ke", default=5)
    entropy = args.get_float("entropy", "e", default=0.70)
    lowercase = args.get_bool("lowercase", default=False)
    mask_lower = args.get_bool("masklowercase", "ml", default=False)
    sam_in = args.get("sam")
    mincov = args.get_int("mincov", "cov", default=1)
    entropy_on = args.get_bool("maskentropy", "me",
                               default=sam_in is None)
    if in1 is None or out is None:
        print("Usage: bbmask in=<ref.fa> out=<masked.fa> "
              "[entropy=0.7 window=80]", file=sys.stderr)
        return 1
    n_masked = 0
    total = 0
    sam_masks = None
    if sam_in:
        scafs = {rec.id.split()[0]: len(rec.bases)
                 for rec in fastx.read_seqs(in1)}
        sam_masks = sam_coverage_masks(sam_in.split(","), scafs, mincov)

    def gen():
        nonlocal n_masked, total
        for rec in fastx.read_seqs(in1):
            seq = np.frombuffer(rec.bases, np.uint8).copy()
            total += len(seq)
            up = seq.copy()
            lo = (up >= ord("a")) & (up <= ord("z"))
            up[lo] -= 32
            if entropy_on:
                mask = window_entropy_mask(up, window, k, entropy)
            else:
                mask = np.zeros(len(seq), bool)
            if sam_masks is not None:
                m2 = sam_masks.get(rec.id.split()[0])
                if m2 is not None:
                    mask |= m2
            if mask_lower:
                mask |= lo
            n_masked += int(mask.sum())
            if lowercase:
                out_seq = np.where(mask, seq + 32 * (seq < ord("a")), seq)
            else:
                out_seq = np.where(mask, np.uint8(ord("N")), up)
            yield fastx.SeqRecord(rec.id, bytes(out_seq.astype(np.uint8)),
                                  rec.quality, rec.numeric_id)

    fastx.write_fasta(out, gen())
    sys.stderr.write(f"Masked {n_masked} of {total} bases "
                     f"({100.0 * n_masked / max(1, total):.2f}%).\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
