"""clumpify: reorder reads by shared pivot k-mer for better compression.

reference: clump/Clumpify.java:21 + KmerComparator:21 + sh/clumpify.sh.
Reads sharing a minimizer-like pivot k-mer (the hashed-minimum canonical
k-mer) are grouped adjacently so gzip finds their shared sequence
(reference groups 3-6x better compression). Optional dedupe removes
duplicates within clumps (reference: clumpify dedupe flag).

Implementation: one vectorized pass computes each read's pivot
(min over positions of hash(canonical k-mer)); reads are then sorted by
(pivot, pivot offset, sequence) — a device-sort-friendly formulation of
the reference's KmerSort.
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


def _hash64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
    x &= np.uint64(2 ** 64 - 1)
    x = (x ^ (x >> np.uint64(29))) * np.uint64(0xC4CEB9FE1A85EC53)
    x &= np.uint64(2 ** 64 - 1)
    return x ^ (x >> np.uint64(32))


def pivots(bases: np.ndarray, k: int) -> np.ndarray:
    """(B, L) -> (B,) uint64 pivot = min hash of canonical k-mers
    (reference: clump/KmerComparator.java:61-67)."""
    kmers, valid = rolling_kmers_batch(bases, k)
    if kmers.shape[1] == 0:
        return np.zeros(bases.shape[0], np.uint64)
    can = np.minimum(kmers, reverse_complement_key(
        np.where(valid, kmers, 0), k))
    h = _hash64(can)
    h = np.where(valid, h, np.uint64(2 ** 64 - 1))
    return h.min(axis=1)


def _sort_records(recs, k: int, do_dedupe: bool):
    """Sort one in-memory group by (pivot, sequence); optionally dedupe.
    Returns (ordered records, n_clumps, n_dups)."""
    b = ReadBatch.from_records(recs)
    piv = pivots(b.bases, k)
    seqs = [r.bases for r in recs]
    order = sorted(range(len(recs)), key=lambda i: (int(piv[i]), seqs[i]))
    n_dup = 0
    out_recs = []
    prev = None
    for i in order:
        if do_dedupe and prev is not None and seqs[i] == seqs[prev] \
                and recs[i].quality == recs[prev].quality:
            n_dup += 1
            continue
        out_recs.append(recs[i])
        prev = i
    return out_recs, len(np.unique(piv)), n_dup


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out")
    k = args.get_int("k", default=31)
    do_dedupe = args.get_bool("dedupe", default=False)
    groups = args.get_int("groups", "g", default=1)
    if in1 is None or out is None:
        print("Usage: clumpify in=<reads.fq> out=<clumped.fq> [k=31] "
              "[dedupe=t] [groups=N]", file=sys.stderr)
        return 1
    if groups <= 1:
        recs = list(fastx.read_seqs(in1))
        if not recs:
            fastx.write_fastq(out, [])
            return 0
        out_recs, n_clumps, n_dup = _sort_records(recs, k, do_dedupe)
        fastx.write_fastq(out, out_recs)
        sys.stderr.write(f"Reads:\t{len(recs)}\nClumps formed:\t"
                         f"{n_clumps}\n"
                         + (f"Duplicates removed:\t{n_dup}\n"
                            if do_dedupe else ""))
        return 0
    # external-memory mode: split by pivot hash into `groups` temp
    # files (KmerSplit), then sort each group independently (KmerSort)
    # — duplicates share a pivot, so dedupe stays exact per group
    # (reference: clump/Clumpify.java:94-118 group splitting,
    # KmerSplit:418 / KmerSort:427)
    import tempfile
    import os
    tmp = [tempfile.NamedTemporaryFile(suffix=f".g{i}.fq",
                                       delete=False)
           for i in range(groups)]
    paths = [t.name for t in tmp]
    for t in tmp:
        t.close()
    fhs = [fastx.xopen(p, "wb") for p in paths]
    n_in = 0
    try:
        for chunk in batched(fastx.read_seqs(in1, fake_quality=30),
                             8192):
            b = ReadBatch.from_records(chunk)
            piv = pivots(b.bases, k)
            gid = (piv % np.uint64(groups)).astype(np.int64)
            for r, gi in zip(chunk, gid):
                n_in += 1
                q = r.quality if r.quality is not None \
                    else b"I" * len(r.bases)
                fhs[gi].write(b"@" + r.id.encode() + b"\n" + r.bases
                              + b"\n+\n" + q + b"\n")
        for fh in fhs:
            fh.close()
        total_clumps = total_dup = n_out = 0
        out_fh = fastx.xopen(out, "wb")
        for p in paths:
            recs = list(fastx.read_seqs(p))
            if not recs:
                continue
            out_recs, n_clumps, n_dup = _sort_records(recs, k,
                                                      do_dedupe)
            total_clumps += n_clumps
            total_dup += n_dup
            for r in out_recs:
                n_out += 1
                q = r.quality if r.quality is not None \
                    else b"I" * len(r.bases)
                out_fh.write(b"@" + r.id.encode() + b"\n" + r.bases
                             + b"\n+\n" + q + b"\n")
        out_fh.close()
    finally:
        for p in paths:
            if os.path.exists(p):
                os.unlink(p)
    sys.stderr.write(f"Reads:\t{n_in}\nGroups:\t{groups}\n"
                     f"Clumps formed:\t{total_clumps}\n"
                     + (f"Duplicates removed:\t{total_dup}\n"
                        if do_dedupe else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
