"""reclusterbykmer: cluster reads by k-mer signature affinity.

reference: cluster/ReclusterByKmer.java:20 — assigns each read to the
cluster whose k-mer spectrum it best matches (ambig modes best/both/
toss/random, :518-528). Here clusters are min-hash sketches of
canonical k-mers built greedily: a read joins the best-matching sketch
above `mincsim` similarity, else founds a new cluster; a second pass
re-assigns every read against the final sketches (the "recluster"
step). Output carries the cluster id in the header, or per-cluster
files via pattern=.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from ..index.build import reverse_complement_key
from ..index.kmerset import rolling_kmers_batch
from ..io import fastx
from ..utils.args import Args

_GOLD = np.int64(-7046029254386353131)  # 64-bit golden-ratio multiplier


def _hash(v: np.ndarray) -> np.ndarray:
    h = v * _GOLD
    return h ^ (h >> np.int64(31))


def read_sketch(seq: bytes, k: int, size: int) -> np.ndarray:
    """Min-hash sketch: the `size` smallest hashed canonical k-mers."""
    arr = np.frombuffer(seq, np.uint8)
    if len(arr) < k:
        return np.empty(0, np.int64)
    km, valid = rolling_kmers_batch(arr[None, :], k)
    km = km[0][valid[0]]
    if len(km) == 0:
        return np.empty(0, np.int64)
    can = np.minimum(km, reverse_complement_key(km, k))
    h = np.unique(_hash(can))
    return h[:size]


def sketch_similarity(a: np.ndarray, b: np.ndarray) -> float:
    if len(a) == 0 or len(b) == 0:
        return 0.0
    inter = len(np.intersect1d(a, b, assume_unique=True))
    return inter / min(len(a), len(b))


class ClusterSet:
    def __init__(self, k: int, sketch_size: int, mincsim: float):
        self.k = k
        self.size = sketch_size
        self.mincsim = mincsim
        self.sketches: List[np.ndarray] = []

    def best(self, sk: np.ndarray):
        best_i, best_s = -1, 0.0
        for i, cs in enumerate(self.sketches):
            s = sketch_similarity(sk, cs)
            if s > best_s:
                best_i, best_s = i, s
        return best_i, best_s

    def assign(self, sk: np.ndarray, grow: bool = True) -> int:
        i, s = self.best(sk)
        if s >= self.mincsim and i >= 0:
            if grow:
                merged = np.unique(np.concatenate(
                    [self.sketches[i], sk]))
                self.sketches[i] = np.sort(merged)[:self.size * 4]
            return i
        if grow:
            self.sketches.append(np.sort(sk))
            return len(self.sketches) - 1
        return i if i >= 0 else 0


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out")
    pattern = args.get("pattern")
    k = args.get_int("k", default=15)
    sketch_size = args.get_int("sketchsize", "size", default=100)
    mincsim = args.get_float("mincsim", "minsim", default=0.3)
    if in1 is None or (out is None and pattern is None):
        print("Usage: reclusterbykmer in=<reads> out=<tagged.fq> "
              "[pattern=c_%.fq] [k=15 mincsim=0.3]", file=sys.stderr)
        return 1
    recs = list(fastx.read_seqs(in1, fake_quality=30))
    sketches = [read_sketch(r.bases, k, sketch_size) for r in recs]
    cs = ClusterSet(k, sketch_size, mincsim)
    # pass 1: greedy founding
    for sk in sketches:
        cs.assign(sk, grow=True)
    # pass 2: recluster every read against the final sketches
    cids = [cs.assign(sk, grow=False) for sk in sketches]

    def _wr(fh, r, cid):
        q = r.quality if r.quality is not None else b"I" * len(r.bases)
        fh.write(b"@" + f"{r.id} cluster={cid}".encode() + b"\n"
                 + r.bases + b"\n+\n" + q + b"\n")

    if out:
        with fastx.xopen(out, "wb") as fh:
            for r, cid in zip(recs, cids):
                _wr(fh, r, cid)
    if pattern:
        by: Dict[int, List] = {}
        for r, cid in zip(recs, cids):
            by.setdefault(cid, []).append(r)
        for cid, rs in sorted(by.items()):
            with fastx.xopen(pattern.replace("%", str(cid)),
                             "wb") as fh:
                for r in rs:
                    _wr(fh, r, cid)
    sys.stderr.write(f"Reads:\t{len(recs)}\nClusters:\t"
                     f"{len(cs.sketches)}\n")
    return 0
