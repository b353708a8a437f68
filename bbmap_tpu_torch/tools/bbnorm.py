"""bbnorm: depth normalization via probabilistic k-mer counting.

reference: jgi/KmerNormalize.java:54 + sh/bbnorm.sh (khist/ecc modes share
the counter). Two passes over the input: pass 1 loads k-mer counts into
the counting Bloom filter (index/kcount.py); pass 2 estimates each read's
depth as the DEPTH_PERCENTILE (default 0.54) of its k-mer counts and
keeps it with probability target/depth. Defaults follow the reference
(target=100, mindepth=5, k=31).

The port's copy of the JAX package's tool: ``device=`` (default cuda)
names the torch device the counting Bloom filter's rows live on; the
k-mers are cut on the host and uploaded a chunk at a time, and ``ecc=t``
looks up each read's k-mers on that device, one lookup a call of
``tadpole.correct_read`` as in the JAX tool.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from ..core.batch import ReadBatch, batched
from ..index.build import reverse_complement_key
from ..index.kcount import KCountArray, make_kca
from ..index.kmerset import rolling_kmers_batch
from ..io import fastx
from ..utils.args import Args

TARGET_DEPTH = 100
MIN_DEPTH = 5
DEPTH_PERCENTILE = 0.54


def canonical_kmers(bases: np.ndarray, k: int):
    kmers, valid = rolling_kmers_batch(bases, k)
    can = np.minimum(kmers, reverse_complement_key(
        np.where(valid, kmers, 0), k))
    return can, valid


def read_depths(kca: KCountArray, bases: np.ndarray, k: int,
                percentile: float) -> np.ndarray:
    """Per-read depth estimate = percentile of its k-mer counts
    (reference: KmerNormalize percentile depth)."""
    B = bases.shape[0]
    can, valid = canonical_kmers(bases, k)
    if can.shape[1] == 0:
        return np.zeros(B, np.int32)
    counts = kca.read(can.ravel()).reshape(can.shape)
    counts = np.where(valid, counts, -1)
    # sort each row; percentile over the valid suffix
    order = np.sort(counts, axis=1)
    nvalid = valid.sum(1)
    depths = np.zeros(B, np.int32)
    m = can.shape[1]
    for i in range(B):
        nv = int(nvalid[i])
        if nv == 0:
            continue
        row = order[i, m - nv:]
        depths[i] = row[min(nv - 1, int(nv * percentile))]
    return depths


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    in2 = args.get("in2")
    out1 = args.get("out", "out1")
    out2 = args.get("out2")
    outt = args.get("outt", "outtossed")
    k = args.get_int("k", default=31)
    target = args.get_int("target", "targetdepth", default=TARGET_DEPTH)
    mindepth = args.get_int("mindepth", "min", default=MIN_DEPTH)
    percentile = args.get_float("percentile", "dp",
                                default=DEPTH_PERCENTILE)
    bits = args.get_int("bits", "cbits", default=16)
    hashes = args.get_int("hashes", default=3)
    mem_cells = args.get_int("cells", default=1 << 26)
    seed = args.get_int("seed", default=0)
    khist_path = args.get("khist", "hist")
    ecc = args.get_bool("ecc", default=False)
    device = args.get("device", default="cuda")
    if in1 is None:
        print("Usage: bbnorm in=<reads> out=<normalized> target=100",
              file=sys.stderr)
        return 1

    kca = make_kca(mem_cells, cell_bits=bits, hashes=hashes, device=device)
    # pass 1: load counts
    n_reads = 0
    reader = fastx.PairedReader(in1, in2)
    for chunk in batched(iter(reader), 8192):
        for recs in ([p[0] for p in chunk],
                     [p[1] for p in chunk] if in2 else []):
            if not recs:
                continue
            b = ReadBatch.from_records(recs)
            can, valid = canonical_kmers(b.bases, k)
            if can.shape[1]:
                kca.increment(can[valid])
            n_reads += b.size
    sys.stderr.write(f"Pass 1: counted kmers of {n_reads} reads; table "
                     f"load {100*kca.used_fraction():.1f}%\n")

    # pass 2: keep-probability by estimated depth
    rng = np.random.default_rng(seed)
    o1 = fastx.xopen(out1, "wb") if out1 else None
    o2 = fastx.xopen(out2, "wb") if out2 else None
    ot = fastx.xopen(outt, "wb") if outt else None

    def wfq(fh, rec):
        if fh is None:
            return
        q = rec.quality if rec.quality is not None else b"I" * len(rec.bases)
        fh.write(b"@" + rec.id.encode() + b"\n" + rec.bases + b"\n+\n"
                 + q + b"\n")

    kept = tossed = 0
    reader = fastx.PairedReader(in1, in2)
    for chunk in batched(iter(reader), 8192):
        recs1 = [p[0] for p in chunk]
        b1 = ReadBatch.from_records(recs1)
        d1 = read_depths(kca, b1.bases, k, percentile)
        if in2:
            recs2 = [p[1] for p in chunk]
            b2 = ReadBatch.from_records(recs2)
            d2 = read_depths(kca, b2.bases, k, percentile)
            depth = np.maximum(d1, d2)
        else:
            depth = d1
        keep_prob = np.where(depth <= target, 1.0,
                             target / np.maximum(depth, 1))
        keep_prob = np.where(depth < mindepth, 0.0, keep_prob)
        keep = rng.random(len(depth)) < keep_prob
        if ecc:
            # error-correct kept reads against the count spectrum
            # (reference: KmerNormalize error correction / ecc.sh)
            class _KcaLookup:
                k = None

                def count(self, kmers):
                    from ..index.build import reverse_complement_key
                    can = np.minimum(
                        kmers, reverse_complement_key(kmers, k))
                    return kca.read(can)
            lk = _KcaLookup()
            lk.k = k
            from .tadpole import correct_read
            for i in range(len(recs1)):
                if keep[i]:
                    r = recs1[i]
                    nb = correct_read(lk, r.bases, k, max(2, mindepth))
                    if nb != r.bases:
                        recs1[i] = fastx.SeqRecord(r.id, nb, r.quality,
                                                   r.numeric_id)
        for i in range(len(recs1)):
            if keep[i]:
                wfq(o1, recs1[i])
                if in2:
                    wfq(o2 if o2 else o1, recs2[i])
                kept += 1
            else:
                wfq(ot, recs1[i])
                if in2:
                    wfq(ot, recs2[i])
                tossed += 1
    for fh in (o1, o2, ot):
        if fh:
            fh.close()
    sys.stderr.write(f"Pass 2: kept {kept}, tossed {tossed} "
                     f"({100.0*kept/max(1,kept+tossed):.2f}% kept)\n")
    if khist_path:
        # histogram of depths of unique kmers is approximated by cell
        # value histogram (reference khist uses exact or bloom counts)
        hist = np.bincount(kca.array[0].cpu().numpy(), minlength=2)
        with fastx.xopen(khist_path, "wt") as fh:
            fh.write("#Depth\tCount\n")
            for d in np.nonzero(hist)[0]:
                if d > 0:
                    fh.write(f"{d}\t{hist[d]}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))


def ecc_main(argv: List[str]) -> int:
    """ecc.sh: error-correct without discarding reads (reference:
    sh/ecc.sh — 'bbnorm with ecc=t keepall passes=1')."""
    extra = []
    keys = {a.split("=")[0].lower() for a in argv if "=" in a}
    if "ecc" not in keys:
        extra.append("ecc=t")
    if "target" not in keys and "targetdepth" not in keys:
        extra.append("target=1000000000")
    if "mindepth" not in keys:
        extra.append("mindepth=0")
    return main(argv + extra)
