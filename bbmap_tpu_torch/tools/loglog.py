"""loglog: k-mer cardinality estimation (HyperLogLog).

reference: jgi/LogLog.java:32 + sh/loglog.sh — estimates distinct k-mer
count without a table.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from ..core.batch import ReadBatch, batched
from ..index.build import reverse_complement_key
from ..index.kmerset import rolling_kmers_batch
from ..io import fastx
from ..utils.args import Args
from .clumpify import _hash64


class LogLog:
    def __init__(self, buckets_log2: int = 12):
        self.p = buckets_log2
        self.m = 1 << buckets_log2
        self.regs = np.zeros(self.m, np.uint8)

    def add(self, kmers: np.ndarray) -> None:
        h = _hash64(kmers)
        idx = (h >> np.uint64(64 - self.p)).astype(np.int64)
        rest = (h << np.uint64(self.p)) | np.uint64(1 << (self.p - 1))
        # leading zero count of the remaining bits + 1
        lz = np.zeros(len(h), np.uint8)
        x = rest
        for shift in (32, 16, 8, 4, 2, 1):
            mask = x < (np.uint64(1) << np.uint64(64 - shift))
            lz = np.where(mask, lz + shift, lz).astype(np.uint8)
            x = np.where(mask, x << np.uint64(shift), x)
        np.maximum.at(self.regs, idx, lz + 1)

    def cardinality(self) -> float:
        m = self.m
        alpha = 0.7213 / (1 + 1.079 / m)
        est = alpha * m * m / np.sum(2.0 ** -self.regs.astype(np.float64))
        zeros = int((self.regs == 0).sum())
        if est <= 2.5 * m and zeros:
            est = m * np.log(m / zeros)
        return float(est)


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    k = args.get_int("k", default=31)
    if in1 is None:
        print("Usage: loglog in=<reads> k=31", file=sys.stderr)
        return 1
    ll = LogLog()
    n = 0
    for chunk in batched(fastx.read_seqs(in1), 8192):
        b = ReadBatch.from_records(chunk)
        kmers, valid = rolling_kmers_batch(b.bases, k)
        if kmers.shape[1]:
            km = kmers[valid]
            can = np.minimum(km, reverse_complement_key(km, k))
            ll.add(can)
        n += b.size
    print(f"Reads:\t{n}")
    print(f"Cardinality:\t{int(ll.cardinality())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
