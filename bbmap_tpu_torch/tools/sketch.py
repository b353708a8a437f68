"""sketch/comparesketch: MinHash genome sketches and comparison.

reference: sketch/SketchTool.java:31, SketchMaker.java, Sketch.java +
sh/sketch.sh, sh/comparesketch.sh — top-N smallest hashed canonical
k-mers per genome (via LongHeapSet), compared by intersection to
estimate identity (WKID/ANI).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np

from ..core.batch import ReadBatch, batched
from ..index.build import reverse_complement_key
from ..index.kmerset import rolling_kmers_batch
from ..io import fastx
from ..utils.args import Args
from .clumpify import _hash64


class Sketch:
    def __init__(self, name: str, k: int, size: int,
                 hashes: np.ndarray, genome_kmers: int = 0):
        self.name = name
        self.k = k
        self.size = size
        self.hashes = hashes  # sorted uint64, the N smallest
        self.genome_kmers = genome_kmers

    @classmethod
    def from_kmer_hashes(cls, name, k, size, all_hashes, genome_kmers):
        uniq = np.unique(all_hashes)
        return cls(name, k, size, uniq[:size], genome_kmers)


def sketch_file(path: str, k: int = 31, size: int = 10000,
                per_sequence: bool = False) -> List[Sketch]:
    out = []
    if per_sequence:
        for rec in fastx.read_seqs(path):
            arr = np.frombuffer(rec.bases, np.uint8)
            kmers, valid = rolling_kmers_batch(arr[None, :], k)
            km = kmers[valid]
            can = np.minimum(km, reverse_complement_key(km, k))
            out.append(Sketch.from_kmer_hashes(
                rec.id, k, size, _hash64(can), len(np.unique(can))))
        return out
    allh = []
    total = 0
    for chunk in batched(fastx.read_seqs(path), 8192):
        b = ReadBatch.from_records(chunk)
        kmers, valid = rolling_kmers_batch(b.bases, k)
        if kmers.shape[1]:
            km = kmers[valid]
            can = np.minimum(km, reverse_complement_key(km, k))
            h = np.unique(_hash64(can))
            allh.append(h[:size * 4])
            total += len(h)
    hashes = np.unique(np.concatenate(allh)) if allh \
        else np.zeros(0, np.uint64)
    import os
    return [Sketch(os.path.basename(path), k, size, hashes[:size], total)]


def compare(a: Sketch, b: Sketch):
    """WKID (weighted k-mer identity proxy) + ANI estimate
    (reference: comparesketch output columns)."""
    n = min(len(a.hashes), len(b.hashes))
    if n == 0:
        return dict(matches=0, wkid=0.0, ani=0.0)
    ha = a.hashes[:n]
    hb = b.hashes[:n]
    inter = np.intersect1d(ha, hb, assume_unique=True)
    wkid = len(inter) / n
    k = a.k
    ani = wkid ** (1.0 / k) if wkid > 0 else 0.0
    return dict(matches=len(inter), wkid=wkid, ani=ani)


def save_sketch(sk: Sketch, path: str) -> None:
    with fastx.xopen(path, "wt") as fh:
        fh.write(f"#SZ:{len(sk.hashes)}\tK:{sk.k}\tGS:{sk.genome_kmers}"
                 f"\tNM:{sk.name}\n")
        for h in sk.hashes:
            fh.write(f"{int(h)}\n")


def load_sketch(path: str) -> Sketch:
    with fastx.xopen(path, "rt") as fh:
        header = fh.readline().strip()
        fields = dict(kv.split(":", 1) for kv in header[1:].split("\t"))
        hashes = np.array([int(x) for x in fh.read().split()], np.uint64)
    return Sketch(fields.get("NM", path), int(fields["K"]),
                  int(fields["SZ"]), hashes, int(fields.get("GS", 0)))


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    inp = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out")
    ref = args.get("ref")
    k = args.get_int("k", default=31)
    size = args.get_int("size", default=10000)
    if inp is None:
        print("Usage: sketch in=<fa> out=<sketch> | "
              "sketch in=<fa> ref=<fa,fa2> (compare mode)",
              file=sys.stderr)
        return 1
    q = sketch_file(inp, k, size)[0]
    if ref:
        print("#Query\tRef\tK\tMatches\tWKID\tANI")
        for rpath in ref.split(","):
            if rpath.endswith(".sketch"):
                r = load_sketch(rpath)
            else:
                r = sketch_file(rpath, k, size)[0]
            c = compare(q, r)
            print(f"{q.name}\t{r.name}\t{k}\t{c['matches']}\t"
                  f"{100.0*c['wkid']:.3f}%\t{100.0*c['ani']:.3f}%")
        return 0
    if out:
        save_sketch(q, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
