"""dedupe: duplicate read/contig removal.

reference: jgi/Dedupe.java:49 + sh/dedupe.sh. Exact duplicates and
reverse-complement duplicates (absorbrc, reference default t), optional
substitution tolerance within equal-length sequences via affix-bucket
comparison, near duplicates within ``e=`` edits, and containment
absorption: a read that lies in a kept read, exactly or within the
tolerance (affix maps + banded verification, Dedupe.java:95-117).

Matching uses content hashes over canonical orientation, vectorized per
batch — the array-native equivalent of the reference's hashed read sets.

The PyTorch port of bbmap_tpu/tools/dedupe.py. ``device=`` (default cuda)
runs the banded edit distances on that device. Reads are taken in blocks
of ``BLOCK``; the decisions are taken on the host in read order, as one
read at a time would take them, from checks made for the whole block:

- with ``e=``, the kept sequences stay on the device in length classes
  (``ops/banded_device.SequenceStore``): one upload of the block, a launch
  of the block kernel for each class that holds lengths within ``e`` of
  one of its reads, and one launch for the block's reads against each
  other;
- with ``ac=t``, the containment check against the containers kept
  before the block: candidates from the affix maps and the exact
  substring test on the host, then, with a tolerance, the windows cut
  from those containers in one pinned upload and one launch of the
  containment kernel (``banded_device.contained_any``, both orientations
  of every read). With ``e=`` its flags come back in the store check's
  one fetch; with ``s=`` alone it makes one fetch of its own. A read
  whose candidates include a container kept earlier in its own block is
  checked against those containers when it is reached, a read at a time
  (``banded_edit``, counted as the ``containment_in_block`` site).
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


# the complement of each byte, for bytes.translate
COMP_BYTES = bytes(COMP_ASCII)


def _offsets(n_can: int) -> tuple:
    """The read offsets probed for a read of n_can bases."""
    # containers index kmers every AFFIX_K positions; querying the
    # first AFFIX_K offsets of this read guarantees one query hits
    # an indexed container kmer for any containment offset
    # (reads >= 2K-1; shorter reads also try the suffix kmer).
    # probe a full mod-K residue window from BOTH ends: one
    # probe per residue class is guaranteed to land on an
    # indexed container k-mer, and a single edit region can
    # break the head OR the tail probes, not both
    head = range(0, min(AFFIX_K, n_can - AFFIX_K + 1))
    tail = range(max(0, n_can - 2 * AFFIX_K + 1), n_can - AFFIX_K + 1)
    offs = tuple(sorted(set(head) | set(tail)))
    return offs + offs


def _probes(can: bytes, rc: bytes, offsets: Dict[int, tuple]) -> tuple:
    """The read's affix probes: (the k-mers of its canonical bytes ``can``
    and of their reverse complement ``rc`` at the probed offsets, the
    offset of each); ``offsets`` caches ``_offsets`` by length. Tuples of
    bytes and ints, which the cyclic garbage collector stops tracking:
    a block holds them for every read."""
    offs = offsets.get(len(can))
    if offs is None:
        offs = offsets[len(can)] = _offsets(len(can))
    half = offs[:len(offs) // 2]
    return tuple([can[o:o + AFFIX_K] for o in half]
                 + [rc[o:o + AFFIX_K] for o in half]), offs


def _candidates(probes, affix, keys=None, first: int = 0) -> set:
    """(container, offset of the read in it) of every probe hit in
    ``affix`` by a container from index ``first`` on; ``keys``, when
    given, the set of affix keys to look at."""
    probe_keys, offs = probes
    hits = affix.keys() & probe_keys if keys is None \
        else keys.intersection(probe_keys)
    if not hits:
        return set()
    return {(ci, p - off) for key, off in zip(probe_keys, offs)
            if key in hits for (ci, p) in affix[key] if ci >= first}


def _exact(can: bytes, rc: bytes, cands, kept_seqs) -> bool:
    """An exact substring of a candidate container in either
    orientation."""
    for ci in {ci for ci, _ in cands}:
        ks = kept_seqs[ci]
        if len(ks) >= len(can) and (can in ks or rc in ks):
            return True
    return False


def _windows(n_can: int, cands, tol: int, kept_seqs) -> List[np.ndarray]:
    """Contained-with-mismatches: the window of each candidate container
    around the read's offset, +- tol, that the banded infix verification
    runs the read in (reference: Dedupe containment absorption verifies
    candidates with the banded aligner, Dedupe.java absorb modes
    :95-117); windows too short for the read are skipped."""
    wins = {}
    for (ci, q0) in cands:
        ks = kept_seqs[ci]
        if len(ks) < n_can:
            continue
        lo = max(0, q0 - tol)
        hi = min(len(ks), q0 + n_can + tol)
        if hi - lo < n_can - tol:
            continue
        wins[ci, lo, hi] = np.frombuffer(ks[lo:hi], np.uint8)
    return list(wins.values())


def _contained_in_block(can: bytes, arr: np.ndarray, rc: bytes, probes,
                        tol: int, kept_seqs, affix, block_keys,
                        first: int, dev) -> bool:
    """The containment check of a read against the containers kept
    earlier in its own block (from index ``first`` on; the affix keys
    they added, ``block_keys``): the exact test, then, with tol > 0, the
    banded infix verification of both read orientations, a launch
    each."""
    from ..ops import banded_device

    cands = _candidates(probes, affix, block_keys, first)
    if not cands:
        return False
    if _exact(can, rc, cands, kept_seqs):
        return True
    wins = _windows(len(can), cands, tol, kept_seqs) if tol > 0 else []
    if not wins:
        return False
    site = "containment_in_block"
    d1 = banded_device.contained_distances(arr, wins, tol, device=dev,
                                           site=site)
    d2 = banded_device.contained_distances(np.frombuffer(rc, np.uint8),
                                           wins, tol, device=dev, site=site)
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
    the decision is ``any(d <= edits)``. The block's kept reads join the
    store at its end, a copy a length class.

    The containment check splits the same way. It is an ``any`` over the
    candidate containers the affix maps give when the read is reached, so
    it is the check against the containers kept before the block (made
    for every read at the block's start: the exact test on the host, the
    banded windows in one launch for the block) or the check against
    those kept earlier in the block (made when the read is reached, only
    where it has such a candidate). The hash check and the affix maps
    still run read by read.
    """
    from ..ops import banded_device

    dev = backend.resolve_device(device)
    seen: Dict[bytes, int] = {}
    sub_buckets: Dict[int, List[np.ndarray]] = {}
    store = banded_device.SequenceStore(dev) if edits > 0 else None
    kept_seqs: List[bytes] = []
    affix: Dict[bytes, List[int]] = {}
    offsets: Dict[int, tuple] = {}      # probed offsets by length
    tol = max(subs, edits)

    def run_block(block):
        cans = [canonical_bytes(rec.bases, absorb_rc) for rec in block]
        hashes = [hashlib.blake2b(c, digest_size=16).digest() for c in cans]
        arrs = [np.frombuffer(c, np.uint8) for c in cans]
        need = [i for i, h in enumerate(hashes) if h not in seen]
        # the containment check against the containers kept before the
        # block: read -> its reverse complement and affix probes; the
        # reads it found contained; the banded pairs (read, window)
        rcs, probes, contained, pairs = {}, {}, set(), []
        if absorb_containment:
            for i in need:
                if len(cans[i]) < AFFIX_K:
                    continue
                rcs[i] = rc = cans[i].translate(COMP_BYTES)[::-1]
                probes[i] = _probes(cans[i], rc, offsets)
                cands = _candidates(probes[i], affix)
                if _exact(cans[i], rc, cands, kept_seqs):
                    contained.add(i)
                elif tol > 0:
                    pairs += [(i, x) for x in _windows(len(cans[i]), cands,
                                                       tol, kept_seqs)]
        slot = {}                  # read -> column of the device block
        hit = tri = None
        if edits > 0 and need:
            # (reference: the BandedAligner verification loop,
            # jni/BandedAlignerJNI.c:588; ops/banded_device.py)
            slot = {i: n for n, i in enumerate(need)}
            lengths = [len(arrs[i]) for i in need]
            q, lq = banded_device.upload_block([arrs[i] for i in need], dev)
            rows = [store.check(q, lq, lengths, edits)[None, :],
                    banded_device.banded_any(q, lq, None, None, edits,
                                             tri=True) if len(need) > 1
                    else torch.zeros((1, 1), dtype=torch.uint8, device=dev)]
            if pairs:
                rows.append(banded_device.contained_any(
                    q, lq, *banded_device.upload_windows(
                        [slot[i] for i, _ in pairs], [x for _, x in pairs],
                        dev), tol)[None, :])
            both = torch.cat(rows).cpu().numpy()
            hit, tri = both[0], both[1:1 + len(need)]
            if pairs:
                contained.update(i for i, _ in pairs if both[-1][slot[i]])
        elif pairs:
            reads = sorted({i for i, _ in pairs})
            col = {i: n for n, i in enumerate(reads)}
            cq, clq = banded_device.upload_block([arrs[i] for i in reads],
                                                 dev)
            flags = banded_device.contained_any(
                cq, clq, *banded_device.upload_windows(
                    [col[i] for i, _ in pairs], [x for _, x in pairs], dev),
                tol).cpu().numpy()
            contained.update(i for i in reads if flags[col[i]])
        kept_cols: List[int] = []
        first = len(kept_seqs)     # the block's first container
        block_keys = set()         # the affix keys its containers added
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
                dup = i in contained or _contained_in_block(
                    can, arr, rcs[i], probes[i], tol, kept_seqs, affix,
                    block_keys, first, dev)
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
                for p in (*range(0, len(can) - AFFIX_K + 1, AFFIX_K),
                          len(can) - AFFIX_K):
                    key = can[p:p + AFFIX_K]
                    affix.setdefault(key, []).append((idx, p))
                    block_keys.add(key)
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
