"""tadpole: k-mer assembler (contig mode).

reference: assemble/Tadpole.java:46 + Tadpole1.java:34 + sh/tadpole.sh.
Contig building follows the reference walk (Tadpole1.contig build
:158-278): seed at k-mers with count >= mincountseed, extend in both
directions while the next k-mer is unique (exactly one of the four
successors passes mincountextend) and unclaimed; branches and dead ends
stop extension. The exact k-mer counts come from the sorted-array counter
(tools/kmercountexact.py) instead of ways-partitioned hash tables; claim
tracking replaces the reference's atomic ownership CAS (single stream).
"""

from __future__ import annotations

import sys
from typing import List, Optional, Set, Tuple

import numpy as np

from ..core.batch import ReadBatch, batched
from ..index.build import reverse_complement_key
from ..io import fastx
from ..utils.args import Args
from .kmercountexact import KmerCounter

BASES = "ACGT"


class KmerLookup:
    def __init__(self, keys: np.ndarray, counts: np.ndarray, k: int):
        self.keys = keys
        self.counts = counts
        self.k = k
        self.mask = (1 << (2 * k)) - 1

    def canonical(self, kmers: np.ndarray) -> np.ndarray:
        return np.minimum(kmers,
                          reverse_complement_key(kmers, self.k))

    def count(self, kmers: np.ndarray) -> np.ndarray:
        can = self.canonical(np.asarray(kmers, np.int64))
        idx = np.searchsorted(self.keys, can)
        idx = np.minimum(idx, max(0, len(self.keys) - 1))
        hit = (self.keys[idx] == can) if len(self.keys) else \
            np.zeros(len(can), bool)
        return np.where(hit, self.counts[np.minimum(
            idx, len(self.counts) - 1)], 0).astype(np.int64)


class KmerLookupBig:
    """K>31 lookup over lexsorted (hi, lo) int64 pairs (Tadpole2's
    ukmer tables, reference: assemble/Tadpole2.java on KmerTableSetU /
    ukmer/Kmer.java long[] k-mers; index/kmer_big.py supplies the
    two-word arithmetic). Walk-side k-mers are arbitrary-precision
    Python ints (2k bits, 31 < k <= 62)."""

    _M62 = (1 << 62) - 1

    def __init__(self, hi: np.ndarray, lo: np.ndarray,
                 counts: np.ndarray, k: int):
        self.hi = hi
        self.lo = lo
        self.counts = counts
        self.k = k
        self.mask = (1 << (2 * k)) - 1

    def _split(self, kms) -> Tuple[np.ndarray, np.ndarray]:
        n = len(kms)
        hi = np.fromiter((x >> 62 for x in kms), np.int64, n)
        lo = np.fromiter((x & self._M62 for x in kms), np.int64, n)
        return hi, lo

    def canonical_list(self, kms) -> List[int]:
        from ..index.kmer_big import canonical_big
        if not len(kms):
            return []
        h, l = self._split(kms)
        ch, cl = canonical_big(h, l, self.k)
        return [(int(a) << 62) | int(b) for a, b in zip(ch, cl)]

    def count_list(self, kms) -> np.ndarray:
        cans = self.canonical_list(kms)
        out = np.zeros(len(cans), np.int64)
        if not len(self.hi):
            return out
        h, l = self._split(cans)
        left = np.searchsorted(self.hi, h, "left")
        right = np.searchsorted(self.hi, h, "right")
        for i in range(len(cans)):
            a, b = int(left[i]), int(right[i])
            if a == b:
                continue
            j = a + int(np.searchsorted(self.lo[a:b], l[i]))
            if j < b and self.lo[j] == l[i]:
                out[i] = self.counts[j]
        return out


def _mk_count_list(lookup):
    """Uniform (count_list, canonical_list, mask) view over the small-K
    and big-K lookups so the walk code is K-agnostic."""
    if isinstance(lookup, KmerLookupBig):
        return lookup.count_list, lookup.canonical_list, lookup.mask

    def count_list(kms):
        return lookup.count(np.asarray(kms, np.int64))

    def canonical_list(kms):
        return [int(x) for x in
                lookup.canonical(np.asarray(kms, np.int64))]

    # duck-typed lookups (e.g. bbnorm's KCountArray view) expose k but
    # not mask
    return count_list, canonical_list, (1 << (2 * lookup.k)) - 1


def extend_right(lookup, kmer: int, claimed: Set[int],
                 min_extend: int, max_len: int) -> List[int]:
    """Extend while the successor is unique; returns appended base
    codes. Works for both K<=31 (int64) and K>31 (python-int) walks."""
    count_list, canonical_list, mask = _mk_count_list(lookup)
    out: List[int] = []
    cur = kmer
    while len(out) < max_len:
        nxt = (cur << 2) & mask
        cands = [nxt | b for b in range(4)]
        cnt = count_list(cands)
        good = cnt >= min_extend
        if good.sum() != 1:
            break
        b = int(np.argmax(good))
        nk = cands[b]
        can = canonical_list([nk])[0]
        if can in claimed:
            break
        claimed.add(can)
        out.append(b)
        cur = nk
    return out


def kmer_to_str(kmer: int, k: int) -> str:
    return "".join(BASES[(kmer >> (2 * j)) & 3]
                   for j in range(k - 1, -1, -1))


def rc_str(s: str) -> str:
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp[c] for c in reversed(s))


def _exists(keys: np.ndarray, cand_canon: np.ndarray) -> np.ndarray:
    """Membership of canonical k-mers in the sorted key array."""
    if len(keys) == 0:
        return np.zeros(cand_canon.shape, bool)
    idx = np.searchsorted(keys, cand_canon)
    idx = np.minimum(idx, len(keys) - 1)
    return keys[idx] == cand_canon


def _degrees(keys: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Out-degree of each node's forward orientation (right extensions)
    and of its rc orientation (= left extensions), in the bidirected
    de Bruijn graph over canonical keys."""
    mask = (1 << (2 * k)) - 1
    rc = reverse_complement_key(keys, k)
    bases = np.arange(4, dtype=np.int64)

    def outdeg(forms: np.ndarray) -> np.ndarray:
        nxt = ((forms[:, None] << 2) & mask) | bases[None, :]
        canon = np.minimum(nxt, reverse_complement_key(
            nxt.ravel(), k).reshape(nxt.shape))
        return _exists(keys, canon).sum(1)

    return outdeg(keys), outdeg(rc)


def shave_rinse(keys: np.ndarray, counts: np.ndarray, k: int,
                shave: bool = True, rinse: bool = True,
                max_depth: Optional[int] = None,
                max_count: int = 1,
                passes: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Remove dead-end hairs (shave) and low-depth bubbles (rinse)
    from the k-mer set before contig building.

    reference: assemble/Shaver2.java (exploreAndMark walks from tips /
    branch points and removes short low-coverage side paths; wired from
    Tadpole.shaveAndRinse, assemble/Tadpole.java:1397). Here: a *hair*
    is a simple path of <= max_depth low-count nodes ending in a dead
    end; a *bubble* is such a path attached to branch nodes at BOTH
    ends. Arrays stay sorted; removal is a boolean mask per pass."""
    if max_depth is None:
        max_depth = k
    for _ in range(passes):
        if len(keys) == 0:
            break
        deg_f, deg_r = _degrees(keys, k)
        low = counts <= max_count
        simple = (deg_f == 1) & (deg_r == 1)
        tip = (deg_f == 0) | (deg_r == 0)
        # candidate hair/bubble members: low-count nodes that are tips
        # or interior nodes of simple paths
        cand = low & (tip | simple)
        if not cand.any():
            break
        # build the set of candidate path components by walking from
        # tips (shave) and from low-count simple nodes adjacent to
        # branches (rinse)
        cand_set = set(keys[cand].tolist())
        branch = (deg_f > 1) | (deg_r > 1)
        branch_set = set(keys[branch].tolist())
        key_set = set(keys.tolist())
        mask_bits = (1 << (2 * k)) - 1

        def neighbors(canon_key: int) -> List[int]:
            out = []
            for form in (canon_key,
                         int(reverse_complement_key(
                             np.array([canon_key], np.int64), k)[0])):
                for b in range(4):
                    nk = ((form << 2) & mask_bits) | b
                    can = min(nk, int(reverse_complement_key(
                        np.array([nk], np.int64), k)[0]))
                    if can in key_set and can != canon_key:
                        out.append(can)
            return out

        to_remove: Set[int] = set()
        seen: Set[int] = set()
        for start in keys[cand & tip] if shave else []:
            start = int(start)
            if start in seen:
                continue
            path = [start]
            seen.add(start)
            cur = start
            ok = True
            while len(path) <= max_depth:
                nbrs = [n for n in neighbors(cur) if n not in path]
                nbrs_cand = [n for n in nbrs if n in cand_set]
                if not nbrs:
                    break  # isolated hair
                if any(n in branch_set for n in nbrs):
                    break  # reached the trunk — hair confirmed
                if len(nbrs_cand) != 1:
                    ok = False
                    break
                cur = nbrs_cand[0]
                path.append(cur)
                seen.add(cur)
            else:
                ok = False  # too long to be a hair
            if ok:
                to_remove.update(path)
        if rinse:
            # bubbles: low-count simple paths whose both neighbors are
            # branch nodes
            for start in keys[cand & simple]:
                start = int(start)
                if start in to_remove:
                    continue
                nbrs = neighbors(start)
                if (len(nbrs) == 2
                        and all(n in branch_set for n in nbrs)):
                    to_remove.add(start)
        if not to_remove:
            break
        keep = ~np.isin(keys, np.fromiter(to_remove, np.int64,
                                          len(to_remove)))
        keys, counts = keys[keep], counts[keep]
    return keys, counts


def _rc_int(x: int, k: int) -> int:
    """Reverse complement of a k-mer held in a python int (any k<=62)."""
    if k <= 31:
        return int(reverse_complement_key(np.array([x], np.int64), k)[0])
    from ..index.kmer_big import rc_big
    M62 = (1 << 62) - 1
    h, l = rc_big(np.array([x >> 62], np.int64),
                  np.array([x & M62], np.int64), k)
    return (int(h[0]) << 62) | int(l[0])


def kmer_to_str_any(x: int, k: int) -> str:
    return "".join(BASES[(x >> (2 * (k - 1 - i))) & 3]
                   for i in range(k))


def _degrees_big(hi: np.ndarray, lo: np.ndarray, k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Out-degrees in the bidirected graph for K>31 key pairs."""
    from ..index.kmer_big import canonical_big, rc_big
    M62 = (1 << 62) - 1
    nh = k - 31
    mask_hi = (1 << (2 * nh)) - 1

    def exists(ch, cl):
        left = np.searchsorted(hi, ch, "left")
        out = np.zeros(len(ch), bool)
        for i in range(len(ch)):
            a = int(left[i])
            while a < len(hi) and hi[a] == ch[i]:
                if lo[a] == cl[i]:
                    out[i] = True
                    break
                if lo[a] > cl[i]:
                    break
                a += 1
        return out

    def outdeg(fh, fl):
        n = len(fh)
        deg = np.zeros(n, np.int64)
        for b in range(4):
            h2 = ((fh << 2) | (fl >> 60)) & mask_hi
            l2 = ((fl << 2) & M62) | b
            ch, cl = canonical_big(h2, l2, k)
            deg += exists(ch, cl).astype(np.int64)
        return deg

    rh, rl = rc_big(hi, lo, k)
    return outdeg(hi, lo), outdeg(rh, rl)


def shave_rinse_big(hi: np.ndarray, lo: np.ndarray, counts: np.ndarray,
                    k: int, shave: bool = True, rinse: bool = True,
                    max_depth: Optional[int] = None, max_count: int = 1,
                    passes: int = 2):
    """K>31 port of shave_rinse over (hi, lo) pairs (reference:
    assemble/Tadpole2.java shaveAndRinse on ukmer tables)."""
    if max_depth is None:
        max_depth = k
    for _ in range(passes):
        if len(hi) == 0:
            break
        deg_f, deg_r = _degrees_big(hi, lo, k)
        low = counts <= max_count
        simple = (deg_f == 1) & (deg_r == 1)
        tip = (deg_f == 0) | (deg_r == 0)
        cand = low & (tip | simple)
        if not cand.any():
            break
        join = lambda h, l: [(int(a) << 62) | int(b)
                             for a, b in zip(h, l)]
        keys_int = join(hi, lo)
        cand_set = set(x for x, c in zip(keys_int, cand) if c)
        branch = (deg_f > 1) | (deg_r > 1)
        branch_set = set(x for x, c in zip(keys_int, branch) if c)
        key_set = set(keys_int)
        mask_bits = (1 << (2 * k)) - 1

        def neighbors(canon_key: int) -> List[int]:
            out = []
            for form in (canon_key, _rc_int(canon_key, k)):
                for b in range(4):
                    nk = ((form << 2) & mask_bits) | b
                    can = min(nk, _rc_int(nk, k))
                    if can in key_set and can != canon_key:
                        out.append(can)
            return out

        to_remove: Set[int] = set()
        seen: Set[int] = set()
        tips = [x for x, c in zip(keys_int, cand & tip) if c] \
            if shave else []
        for start in tips:
            if start in seen:
                continue
            path = [start]
            seen.add(start)
            cur = start
            ok = True
            while len(path) <= max_depth:
                nbrs = [n for n in neighbors(cur) if n not in path]
                nbrs_cand = [n for n in nbrs if n in cand_set]
                if not nbrs:
                    break
                if any(n in branch_set for n in nbrs):
                    break
                if len(nbrs_cand) != 1:
                    ok = False
                    break
                cur = nbrs_cand[0]
                path.append(cur)
                seen.add(cur)
            else:
                ok = False
            if ok:
                to_remove.update(path)
        if rinse:
            for start, c in zip(keys_int, cand & simple):
                if not c or start in to_remove:
                    continue
                nbrs = neighbors(start)
                if (len(nbrs) == 2
                        and all(n in branch_set for n in nbrs)):
                    to_remove.add(start)
        if not to_remove:
            break
        keep = np.array([x not in to_remove for x in keys_int], bool)
        hi, lo, counts = hi[keep], lo[keep], counts[keep]
    return hi, lo, counts


def assemble_big(hi: np.ndarray, lo: np.ndarray, counts: np.ndarray,
                 k: int, min_seed: int = 3, min_extend: int = 2,
                 min_contig: int = 0, max_contig: int = 10_000_000
                 ) -> List[str]:
    """Tadpole2: contig building for 31 < K <= 62 (reference:
    assemble/Tadpole2.java:158-278 equivalent over ukmer pairs)."""
    lookup = KmerLookupBig(hi, lo, counts, k)
    min_contig = max(min_contig, k + 1)
    claimed: Set[int] = set()
    contigs: List[str] = []
    order = np.argsort(-counts, kind="stable")
    for oi in order:
        if counts[oi] < min_seed:
            break
        seed = (int(hi[oi]) << 62) | int(lo[oi])
        if seed in claimed:
            continue
        claimed.add(seed)
        right = extend_right(lookup, seed, claimed, min_extend,
                             max_contig)
        left = extend_right(lookup, _rc_int(seed, k), claimed,
                            min_extend, max_contig)
        mid = kmer_to_str_any(seed, k)
        right_s = "".join(BASES[b] for b in right)
        left_s = rc_str("".join(BASES[b] for b in left))
        contig = left_s + mid + right_s
        if len(contig) >= min_contig:
            contigs.append(contig)
    contigs.sort(key=len, reverse=True)
    return contigs


def assemble(keys: np.ndarray, counts: np.ndarray, k: int,
             min_seed: int = 3, min_extend: int = 2,
             min_contig: int = 0, max_contig: int = 10_000_000
             ) -> List[str]:
    lookup = KmerLookup(keys, counts, k)
    min_contig = max(min_contig, k + 1)
    claimed: Set[int] = set()
    contigs: List[str] = []
    # seed in decreasing count order (reference multi-pass thresholds)
    order = np.argsort(-counts, kind="stable")
    for oi in order:
        if counts[oi] < min_seed:
            break
        seed = int(keys[oi])
        if seed in claimed:
            continue
        claimed.add(seed)
        right = extend_right(lookup, seed, claimed, min_extend,
                             max_contig)
        # extend left = extend right from the rc seed
        rc_seed = int(reverse_complement_key(
            np.array([seed], np.int64), k)[0])
        left = extend_right(lookup, rc_seed, claimed, min_extend,
                            max_contig)
        mid = kmer_to_str(seed, k)
        right_s = "".join(BASES[b] for b in right)
        left_s = rc_str("".join(BASES[b] for b in left))
        contig = left_s + mid + right_s
        if len(contig) >= min_contig:
            contigs.append(contig)
    contigs.sort(key=len, reverse=True)
    return contigs


def _rolling_ints(arr: np.ndarray, k: int):
    """All k-mers of a sequence as python ints + validity, any k<=62."""
    if k <= 31:
        from ..index.kmerset import rolling_kmers_batch
        km, valid = rolling_kmers_batch(arr[None, :], k)
        return [int(x) for x in km[0]], valid[0]
    from ..index.kmer_big import rolling_kmers_big
    hi, lo, valid = rolling_kmers_big(arr[None, :], k)
    return [(int(a) << 62) | int(b)
            for a, b in zip(hi[0], lo[0])], valid[0]


def extend_sequence(lookup, seq: bytes, k: int,
                    extend_len: int, min_extend: int = 2) -> bytes:
    """Extend a sequence right/left while successors are unique
    (reference: Tadpole mode=extend, extendLeft/extendRight; K>31 via
    the Tadpole2 lookup)."""
    import numpy as _np
    arr = _np.frombuffer(seq, _np.uint8)
    if len(arr) < k:
        return seq
    claimed: Set[int] = set()
    km, valid = _rolling_ints(arr, k)
    if not valid[-1]:
        right = []
    else:
        right = extend_right(lookup, km[-1], claimed,
                             min_extend, extend_len)
    if not valid[0]:
        left = []
    else:
        left = extend_right(lookup, _rc_int(km[0], k), claimed,
                            min_extend, extend_len)
    rs = "".join(BASES[b] for b in right)
    ls = rc_str("".join(BASES[b] for b in left))
    return ls.encode() + seq + rs.encode()


def correct_read(lookup, seq: bytes, k: int,
                 min_count: int = 2) -> bytes:
    """Simple k-mer spectrum error correction: for each position covered
    only by weak k-mers, try the substitution that maximizes the minimum
    covering k-mer count (reference: Tadpole mode=correct, pincer/tail
    correction simplified; K>31 via the Tadpole2 lookup)."""
    import numpy as _np
    arr = bytearray(seq)
    n = len(arr)
    if n < k:
        return seq
    count_list, _canon, _mask = _mk_count_list(lookup)

    def covering_ok(a: bytearray) -> _np.ndarray:
        km, valid = _rolling_ints(
            _np.frombuffer(bytes(a), _np.uint8), k)
        cnt = count_list(km)
        return _np.where(valid, cnt, 0)

    cnt = covering_ok(arr)
    weak = cnt < min_count
    if not weak.any():
        return bytes(arr)
    for pos in range(n):
        lo = max(0, pos - k + 1)
        hi = min(len(cnt), pos + 1)
        if not weak[lo:hi].all():
            continue
        # every kmer covering pos is weak -> candidate error
        orig = arr[pos]
        best_base, best_min = orig, -1
        for b in b"ACGT":
            arr[pos] = b
            c2 = covering_ok(arr)
            m = int(c2[lo:hi].min()) if hi > lo else 0
            if m > best_min:
                best_min, best_base = m, b
        if best_min >= min_count:
            arr[pos] = best_base
            cnt = covering_ok(arr)
            weak = cnt < min_count
        else:
            arr[pos] = orig
    return bytes(arr)


def main(argv: List[str]) -> int:
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out", "outc")
    k = args.get_int("k", default=31)
    mode = args.get("mode", default="contig")
    min_seed = args.get_int("mincountseed", "mcs", default=3)
    min_extend = args.get_int("mincountextend", "mce", default=2)
    min_contig = args.get_int("mincontig", "mincontiglen",
                              default=max(100, k + 10))
    if in1 is None or out is None:
        print("Usage: tadpole in=<reads> out=<contigs.fa> k=31 "
              "mode=contig", file=sys.stderr)
        return 1
    extra = args.get("extra")  # separate kmer source for extend/correct
    big = k > 31   # Tadpole2: ukmer-backed assembly for 31 < K <= 62
    # (reference: assemble/Tadpole2.java dispatched from Tadpole.java
    # when K > 31; index/kmer_big.py is the KmerTableSetU analog)
    if big:
        from ..index.kmer_big import KmerCounterBig
        counter = KmerCounterBig(k)
    else:
        counter = KmerCounter(k)
    n = 0
    kmer_src = extra if (extra and mode in ("extend", "correct")) else in1
    for chunk in batched(fastx.read_seqs(kmer_src), 8192):
        b = ReadBatch.from_records(chunk)
        counter.add_batch(b.bases)
        n += b.size
    if big:
        khi, klo, counts = counter.finish()
        keys = None
    else:
        keys, counts = counter.finish()
    if mode in ("extend", "correct"):
        lookup = KmerLookupBig(khi, klo, counts, k) if big \
            else KmerLookup(keys, counts, k)
        extend_len = args.get_int("extendleft", "extendright", "el", "er",
                                  default=100)
        out_fh = fastx.xopen(out, "wb")
        fmt = fastx.sniff_format(in1)
        n2 = 0
        for rec in fastx.read_seqs(in1):
            if mode == "extend":
                nb = extend_sequence(lookup, rec.bases, k, extend_len,
                                     min_extend)
                q = None
            else:
                nb = correct_read(lookup, rec.bases, k, min_extend)
                q = rec.quality
            n2 += 1
            if fmt == "fasta":
                out_fh.write(b">" + rec.id.encode() + b"\n" + nb + b"\n")
            else:
                qq = q if q is not None else b"I" * len(nb)
                if len(qq) != len(nb):
                    qq = b"I" * len(nb)
                out_fh.write(b"@" + rec.id.encode() + b"\n" + nb
                             + b"\n+\n" + qq + b"\n")
        out_fh.close()
        sys.stderr.write(f"Processed {n2} sequences (mode={mode}).\n")
        return 0
    if mode != "contig":
        print(f"mode={mode} not implemented", file=sys.stderr)
        return 1
    do_shave = args.get_bool("shave", default=False)
    do_rinse = args.get_bool("rinse", default=False)
    if do_shave or do_rinse:
        n_before = len(counts)
        sd = args.get_int("shavedepth", default=k)
        mc = args.get_int("shavedepth2", "maxshavecount", default=1)
        if big:
            khi, klo, counts = shave_rinse_big(
                khi, klo, counts, k, shave=do_shave, rinse=do_rinse,
                max_depth=sd, max_count=mc)
        else:
            keys, counts = shave_rinse(
                keys, counts, k, shave=do_shave, rinse=do_rinse,
                max_depth=sd, max_count=mc)
        sys.stderr.write(f"Shave/rinse removed "
                         f"{n_before - len(counts)} kmers.\n")
    if big:
        contigs = assemble_big(khi, klo, counts, k, min_seed,
                               min_extend, min_contig)
    else:
        contigs = assemble(keys, counts, k, min_seed, min_extend,
                           min_contig)
    with fastx.xopen(out, "wt") as fh:
        for i, c in enumerate(contigs):
            fh.write(f">contig_{i+1},length={len(c)}\n")
            for j in range(0, len(c), 70):
                fh.write(c[j:j + 70] + "\n")
    total = sum(len(c) for c in contigs)
    sys.stderr.write(f"Reads:\t{n}\nUnique kmers:\t{len(counts)}\n"
                     f"Contigs:\t{len(contigs)}\tTotal length:\t{total}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))


def _n50(lengths: List[int]) -> int:
    if not lengths:
        return 0
    lengths = sorted(lengths, reverse=True)
    half = sum(lengths) / 2
    acc = 0
    for ln in lengths:
        acc += ln
        if acc >= half:
            return ln
    return lengths[-1]


def wrapper_main(argv: List[str]) -> int:
    """tadpolewrapper: assemble over a sweep of k values, keep the
    assembly with the best N50 (reference: assemble/TadpoleWrapper.java
    — runs Tadpole for each k in a list and selects the best result)."""
    args = Args.parse(argv)
    in1 = args.get("in", "in1") or (args.positional[0]
                                    if args.positional else None)
    out = args.get("out", "outc")
    ks = args.get("k", "klist")
    if in1 is None or out is None:
        print("Usage: tadpolewrapper in=<reads> out=<contigs.fa> "
              "k=21,31,41", file=sys.stderr)
        return 1
    k_values = [int(x) for x in (ks or "21,31,41").split(",")]
    import tempfile
    import os
    best = None  # (n50, k, path)
    tmp_files = []
    fwd = [a for a in argv
           if not a.lower().startswith(("k=", "klist=", "out=", "outc="))]
    for k in k_values:
        tmp = tempfile.NamedTemporaryFile(suffix=".fa", delete=False)
        tmp.close()
        tmp_files.append(tmp.name)
        rc = main(fwd + [f"k={k}", f"out={tmp.name}"])
        if rc != 0:
            continue
        lengths = [len(r.bases) for r in fastx.read_seqs(tmp.name)]
        n50 = _n50(lengths)
        sys.stderr.write(f"k={k}: contigs={len(lengths)} N50={n50}\n")
        if best is None or n50 > best[0]:
            best = (n50, k, tmp.name)
    if best is None:
        print("all assemblies failed", file=sys.stderr)
        return 1
    import shutil
    shutil.copyfile(best[2], out)
    for t in tmp_files:
        os.unlink(t)
    sys.stderr.write(f"Best: k={best[1]} N50={best[0]}\n")
    return 0
