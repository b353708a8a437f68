"""dedupe: duplicate read/contig removal.

reference: jgi/Dedupe.java:49 + sh/dedupe.sh. Round-1 coverage: exact
duplicates and reverse-complement duplicates (absorbrc, reference default
t), optional substitution tolerance within equal-length sequences via
affix-bucket comparison (reference uses affix maps + banded verification,
Dedupe.java:95-117); containment/overlap absorption is a later milestone.

Matching uses content hashes over canonical orientation, vectorized per
batch — the array-native equivalent of the reference's hashed read sets.

The PyTorch port of bbmap_tpu/tools/dedupe.py. ``device=`` (default cuda)
runs the banded edit distances (``e=`` and the contained-with-edits
check) on that device: the kept sequences stay there in length classes
(``ops/banded_device.SequenceStore``). Reads are checked with ``e=`` in
blocks of ``BLOCK`` reads: one upload of the block, a launch of the block
kernel for each class that holds lengths within ``e`` of one of them, one
launch for the block's reads against each other, and one fetch; the
decisions are then taken on the host in read order, as one read at a time
would take them.
"""

from __future__ import annotations

import hashlib
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import backend
from ..core.bases import COMP_ASCII
from ..io import fastx
from ..utils.args import Args


def canonical_bytes(seq: bytes, absorb_rc: bool) -> bytes:
    if not absorb_rc:
        return seq
    rc = bytes(COMP_ASCII[np.frombuffer(seq, np.uint8)][::-1])
    return seq if seq <= rc else rc


AFFIX_K = 31


# reads checked with e= a block: one upload, a launch a near length class
# and one for the block's reads against each other, one fetch
BLOCK = 512


def _contained(can: bytes, arr: np.ndarray, tol: int, kept_seqs, affix,
               dev) -> bool:
    """The containment check of a read (its canonical bytes): an exact
    substring of a kept sequence in either orientation, or, with tol > 0,
    within tol edits of a window of one (banded infix verification),
    candidates from the affix maps."""
    from ..ops import banded_device

    # containers index kmers every AFFIX_K positions; querying the
    # first AFFIX_K offsets of this read guarantees one query hits
    # an indexed container kmer for any containment offset
    # (reads >= 2K-1; shorter reads also try the suffix kmer)
    rc = bytes(COMP_ASCII[arr][::-1])
    cands = set()
    # probe a full mod-K residue window from BOTH ends: one
    # probe per residue class is guaranteed to land on an
    # indexed container k-mer, and a single edit region can
    # break the head OR the tail probes, not both
    n_can = len(can)
    head = range(0, min(AFFIX_K, n_can - AFFIX_K + 1))
    tail = range(max(0, n_can - 2 * AFFIX_K + 1), n_can - AFFIX_K + 1)
    for off in set(head) | set(tail):
        for (ci, p) in affix.get(can[off:off + AFFIX_K], []):
            cands.add((ci, p - off, 0))
        for (ci, p) in affix.get(rc[off:off + AFFIX_K], []):
            cands.add((ci, p - off, 1))
    for (ci, q0, orient) in cands:
        ks = kept_seqs[ci]
        if len(ks) >= len(can) and (can in ks or rc in ks):
            return True
    if tol <= 0 or not cands:
        return False
    # contained-with-mismatches: banded infix verification of the read
    # against each candidate container window (reference: Dedupe
    # containment absorption verifies candidates with the banded aligner,
    # Dedupe.java absorb modes :95-117); the query orientation is handled
    # by testing both read orientations
    wins = []
    for (ci, q0, orient) in cands:
        ks = kept_seqs[ci]
        if len(ks) < len(can):
            continue
        lo = max(0, q0 - tol)
        hi = min(len(ks), q0 + len(can) + tol)
        if hi - lo < len(can) - tol:
            continue
        wins.append(np.frombuffer(ks[lo:hi], np.uint8))
    if not wins:
        return False
    d1 = banded_device.contained_distances(arr, wins, tol, device=dev)
    d2 = banded_device.contained_distances(np.frombuffer(rc, np.uint8),
                                           wins, tol, device=dev)
    return bool((np.minimum(d1, d2) <= tol).any())


def dedupe_stream(records, absorb_rc: bool = True, subs: int = 0,
                  edits: int = 0, absorb_containment: bool = False,
                  keep_first: bool = True, clusters: dict = None,
                  device="cuda"):
    """Yields (record, is_duplicate).

    - exact/rc duplicates via canonical content hash
    - subs>0 / edits>0: near-duplicate detection within same-length
      buckets (hamming) or via banded edit distance
      (reference: Dedupe banded-aligner verification)
    - absorb_containment: shorter sequences absorbed when they are exact
      substrings (either orientation) of a kept sequence, candidate pairs
      found by affix (prefix/suffix k-mer) maps
      (reference: jgi/Dedupe.java affix maps :95-117)

    With edits>0 the kept sequences sit in a device store in length
    classes. Reads are taken BLOCK at a time: the reads whose hash was
    not seen before the block are checked on the device against the store
    as it stood before the block, and against each other (d(i, j) for j <
    i); then, in read order, read i is a near duplicate if it hit the
    store or lies within edits of an earlier read of the block that was
    kept. That is the decision of one read at a time against every read
    kept before it: a candidate of a length further off gives edits+1,
    the decision is ``any(d <= edits)``, and the hash check, the affix
    maps and the containment check still run read by read. The block's
    kept reads join the store at its end, a copy a length class.
    """
    from ..ops import banded_device

    dev = backend.resolve_device(device)
    seen: Dict[bytes, int] = {}
    sub_buckets: Dict[int, List[np.ndarray]] = {}
    store = banded_device.SequenceStore(dev) if edits > 0 else None
    kept_seqs: List[bytes] = []
    affix: Dict[bytes, List[int]] = {}

    def run_block(block):
        cans = [canonical_bytes(rec.bases, absorb_rc) for rec in block]
        hashes = [hashlib.blake2b(c, digest_size=16).digest() for c in cans]
        arrs = [np.frombuffer(c, np.uint8) for c in cans]
        slot = {}                  # read -> column of the device block
        hit = tri = None
        if edits > 0:
            # (reference: the BandedAligner verification loop,
            # jni/BandedAlignerJNI.c:588; ops/banded_device.py)
            need = [i for i, h in enumerate(hashes) if h not in seen]
            slot = {i: n for n, i in enumerate(need)}
            if need:
                lengths = [len(arrs[i]) for i in need]
                q, lq = banded_device.upload_block([arrs[i] for i in need],
                                                   dev)
                flags = store.check(q, lq, lengths, edits)
                tri_d = banded_device.banded_any(
                    q, lq, None, None, edits, tri=True) if len(need) > 1 \
                    else torch.zeros((1, 1), dtype=torch.uint8, device=dev)
                both = torch.cat([flags[None, :], tri_d]).cpu().numpy()
                hit, tri = both[0], both[1:]
        kept_cols: List[int] = []
        for i, rec in enumerate(block):
            can, h, arr = cans[i], hashes[i], arrs[i]
            if h in seen:
                if clusters is not None:
                    clusters.setdefault(seen[h], []).append(rec.id)
                yield rec, True
                continue
            dup = False
            if edits > 0:
                n = slot[i]
                dup = bool(hit[n]) or bool(tri[n, kept_cols].any())
            elif subs > 0:
                for other in sub_buckets.get(len(can), []):
                    if len(other) == len(arr) \
                            and int((other != arr).sum()) <= subs:
                        dup = True
                        break
            if not dup and absorb_containment and len(can) >= AFFIX_K:
                dup = _contained(can, arr, max(subs, edits), kept_seqs,
                                 affix, dev)
            if dup:
                if clusters is not None:
                    clusters.setdefault("~near", []).append(rec.id)
                yield rec, True
                continue
            seen[h] = rec.id if clusters is not None else 1
            if edits > 0:
                kept_cols.append(slot[i])
            elif subs > 0:
                sub_buckets.setdefault(len(can), []).append(arr)
            if absorb_containment and len(can) >= AFFIX_K:
                idx = len(kept_seqs)
                kept_seqs.append(can)
                # index every AFFIX_K-th interior kmer + both affixes so
                # shorter contained reads can find this container
                for p in range(0, len(can) - AFFIX_K + 1, AFFIX_K):
                    affix.setdefault(can[p:p + AFFIX_K],
                                     []).append((idx, p))
                affix.setdefault(can[-AFFIX_K:],
                                 []).append((idx, len(can) - AFFIX_K))
            yield rec, False
        if kept_cols:
            store.append(q, lq, [len(arrs[i]) for i in need], kept_cols)

    block: List = []
    for rec in records:
        block.append(rec)
        if len(block) == BLOCK:
            yield from run_block(block)
            block = []
    if block:
        yield from run_block(block)


class _UnionFind:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, a: int) -> int:
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


def find_overlaps(seqs: List[bytes], min_overlap: int = 200,
                  subs: int = 0) -> List[Tuple[int, int, int, int]]:
    """Suffix-prefix overlap edges between sequences.

    Returns (i, j, overlap_len, orientation) with orientation 0 =
    suffix(i)~prefix(j), 1 = suffix(i)~prefix(rc(j)).
    reference: jgi/Dedupe.java findOverlaps (overlap detection via affix
    k-mer maps + banded verification, wired by sh/dedupe.sh
    findoverlaps=t). Candidates here come from an all-positions k-mer map
    keyed by each sequence's prefix k-mer; verification allows `subs`
    mismatches over the overlap."""
    kmap: Dict[bytes, List[Tuple[int, int]]] = {}
    for i, s in enumerate(seqs):
        for p in range(0, len(s) - AFFIX_K + 1):
            kmap.setdefault(s[p:p + AFFIX_K], []).append((i, p))
    edges: List[Tuple[int, int, int, int]] = []
    seen_pairs = set()
    for j, s in enumerate(seqs):
        if len(s) < min_overlap:
            continue
        rc = bytes(COMP_ASCII[np.frombuffer(s, np.uint8)][::-1])
        for orient, b_seq in ((0, s), (1, rc)):
            pref = b_seq[:AFFIX_K]
            for (i, pos) in kmap.get(pref, []):
                if i == j:
                    continue
                a = seqs[i]
                ov = len(a) - pos
                if ov < min_overlap or ov > len(b_seq):
                    continue
                key = (min(i, j), max(i, j), orient)
                if key in seen_pairs:
                    continue
                x = np.frombuffer(a[pos:], np.uint8)
                y = np.frombuffer(b_seq[:ov], np.uint8)
                if int((x != y).sum()) <= subs:
                    seen_pairs.add(key)
                    edges.append((i, j, ov, orient))
    return edges


def cluster_by_overlap(records: List, min_overlap: int = 200,
                       subs: int = 0):
    """Group records into overlap-connected clusters
    (reference: jgi/Dedupe.java cluster=t — union of overlap edges).
    Returns (cluster_id per record, edges)."""
    seqs = [r.bases for r in records]
    edges = find_overlaps(seqs, min_overlap, subs)
    uf = _UnionFind(len(records))
    for (i, j, _, _) in edges:
        uf.union(i, j)
    roots = [uf.find(i) for i in range(len(records))]
    remap: Dict[int, int] = {}
    cids = []
    for r in roots:
        if r not in remap:
            remap[r] = len(remap)
        cids.append(remap[r])
    return cids, edges


def write_dot(path: str, records: List, edges) -> None:
    """GraphViz overlap graph (reference: sh/dedupe.sh dot= flag,
    jgi/Dedupe.java writeGraph)."""
    with open(path, "w") as fh:
        fh.write("graph overlaps {\n")
        for r in records:
            fh.write(f'  "{r.id}";\n')
        for (i, j, ov, orient) in edges:
            style = "" if orient == 0 else " style=dashed"
            fh.write(f'  "{records[i].id}" -- "{records[j].id}" '
                     f'[label="{ov}"{style}];\n')
        fh.write("}\n")


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out", "out1")
    outd = args.get("outd", "outduplicate")
    absorb_rc = args.get_bool("absorbrc", "rc", default=True)
    subs = args.get_int("subs", "s", "maxsubs", default=0)
    edits = args.get_int("edits", "e", "maxedits", default=0)
    absorb_containment = args.get_bool("absorbcontainment", "ac",
                                       default=True)
    csf = args.get("csf", "clusterstats", "outgraph")
    do_overlap = args.get_bool("findoverlaps", "fo", default=False)
    do_cluster = args.get_bool("cluster", "c", default=False)
    min_overlap = args.get_int("minoverlap", "mo", default=200)
    dot = args.get("dot", "graph")
    pattern = args.get("pattern")
    device = backend.resolve_device(args.get("device", default="cuda"))
    if in1 is None:
        print("Usage: dedupe in=<reads> out=<unique> [outd=] [subs=N] "
              "[findoverlaps=t cluster=t dot=g.dot pattern=c_%.fa] "
              "[device=cuda|cpu]",
              file=sys.stderr)
        return 1
    fmt = fastx.sniff_format(in1)
    out_fh = fastx.xopen(out, "wb") if out else None
    outd_fh = fastx.xopen(outd, "wb") if outd else None

    def emit(fh, rec):
        if fh is None:
            return
        if fmt == "fasta":
            fh.write(b">" + rec.id.encode() + b"\n" + rec.bases + b"\n")
        else:
            q = rec.quality if rec.quality is not None \
                else b"I" * len(rec.bases)
            fh.write(b"@" + rec.id.encode() + b"\n" + rec.bases
                     + b"\n+\n" + q + b"\n")

    n = dups = 0
    clusters = {} if csf else None
    kept_records = [] if (do_overlap or do_cluster) else None
    for rec, is_dup in dedupe_stream(fastx.read_seqs(in1), absorb_rc,
                                     subs, edits, absorb_containment,
                                     clusters=clusters, device=device):
        n += 1
        if is_dup:
            dups += 1
            emit(outd_fh, rec)
        else:
            if kept_records is not None:
                kept_records.append(rec)
            emit(out_fh, rec)
    if kept_records is not None:
        cids, edges = cluster_by_overlap(kept_records, min_overlap, subs)
        sys.stderr.write(f"Overlap edges:\t{len(edges)}\n"
                         f"Clusters:\t{len(set(cids))}\n")
        if dot:
            write_dot(dot, kept_records, edges)
        if pattern and do_cluster:
            by_cid: Dict[int, List] = {}
            for r, cid in zip(kept_records, cids):
                by_cid.setdefault(cid, []).append(r)
            for cid, recs in sorted(by_cid.items()):
                with fastx.xopen(pattern.replace("%", str(cid)),
                                 "wb") as fh:
                    for r in recs:
                        q = r.quality if r.quality is not None \
                            else b"I" * len(r.bases)
                        if fmt == "fasta":
                            fh.write(b">" + r.id.encode() + b"\n"
                                     + r.bases + b"\n")
                        else:
                            fh.write(b"@" + r.id.encode() + b"\n"
                                     + r.bases + b"\n+\n" + q + b"\n")
    for fh in (out_fh, outd_fh):
        if fh is not None:
            fh.close()
    if csf and clusters is not None:
        with open(csf, "w") as fh:
            fh.write("#representative\tmembers\n")
            for rep, members in clusters.items():
                fh.write(f"{rep}\t{','.join(members)}\n")
    sys.stderr.write(f"Input:\t{n}\nDuplicates:\t{dups}\n"
                     f"Result:\t{n - dups}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))


def dedupe2_main(argv: List[str]) -> int:
    """dedupe2: Dedupe with arbitrarily many affix maps.

    reference: jgi/Dedupe2.java:49 + sh/dedupe2.sh. The Java Dedupe caps
    ``numaffixmaps`` at 2; Dedupe2 lifts that cap so overlaps whose
    terminal k-mers carry errors can still be found via deeper affix
    indexing (Dedupe2.java:89, :322 'numaffixmaps/nam'). This
    implementation's candidate generation already indexes BOTH affixes
    plus every AFFIX_K-th interior k-mer of each sequence
    (dedupe_stream above) — a superset of any nam=N affix-map recall —
    and every candidate pair is verified exactly (hamming or banded
    edit distance), so results are independent of nam. The flag is
    accepted and validated for CLI compatibility.
    """
    args = Args.parse(argv)
    nam = args.get_int("numaffixmaps", "nam", default=1)
    if nam < 1:
        print("numaffixmaps must be >= 1", file=sys.stderr)
        return 1
    rest = [a for a in argv
            if not a.split("=")[0].lower().replace("_", "")
            in ("numaffixmaps", "nam")]
    return main(rest)
