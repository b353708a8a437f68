"""bbcountunique: per-interval novel-kmer rate (library uniqueness /
saturation curve).

reference: jgi/CalcUniqueness.java + sh/bbcountunique.sh — tracks the
fraction of reads whose leading k-mer (and random k-mer) is novel,
reported per interval; the curve's decay estimates library complexity.
"""

from __future__ import annotations

import sys
from typing import List, Set

import numpy as np

from ..index.kmerset import rolling_kmers_batch
from ..io import fastx
from ..utils.args import Args


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out")
    k = args.get_int("k", default=25)
    interval = args.get_int("interval", default=25000)
    if in1 is None or out is None:
        print("Usage: bbcountunique in=<reads> out=<hist.txt> [k=25] "
              "[interval=25000]", file=sys.stderr)
        return 1
    seen_first: Set[int] = set()
    seen_rand: Set[int] = set()
    rng = np.random.default_rng(0)
    rows = []
    count = first_novel = rand_novel = 0
    for rec in fastx.read_seqs(in1):
        arr = np.frombuffer(rec.bases, np.uint8)
        if len(arr) < k:
            continue
        kmers, valid = rolling_kmers_batch(arr[None, :], k)
        if not valid[0, 0]:
            continue
        count += 1
        first = int(kmers[0, 0])
        if first not in seen_first:
            seen_first.add(first)
            first_novel += 1
        vi = np.nonzero(valid[0])[0]
        if len(vi):
            r = int(kmers[0, vi[int(rng.integers(0, len(vi)))]])
            if r not in seen_rand:
                seen_rand.add(r)
                rand_novel += 1
        if count % interval == 0:
            rows.append((count, 100.0 * first_novel / interval,
                         100.0 * rand_novel / interval))
            first_novel = rand_novel = 0
    if count % interval:
        rem = count % interval
        rows.append((count, 100.0 * first_novel / rem,
                     100.0 * rand_novel / rem))
    with open(out, "w") as fh:
        fh.write("#count\tfirst\trand\n")
        for c, f, r in rows:
            fh.write(f"{c}\t{f:.3f}\t{r:.3f}\n")
    sys.stderr.write(f"Reads:\t{count}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
