"""Reference k-mer set for BBDuk/Seal-style matching.

Replaces the reference's ways-partitioned open-addressing tables
(reference: kmer/AbstractKmerTable.java:19, jgi/BBDukF.addToMap:1785) with
a sorted int64 value array + parallel id array: membership tests become
vectorized searchsorted over every k-mer of a read batch at once — the
array layout a device scan wants, rather than pointer-chasing hash
forests. The port's copy of the JAX package's module: the scans take a
device and run the torch scan of ``kmerset_device`` there; the numpy
search stays as their plain reference (``*_plain``).

Value encoding follows the reference exactly (jgi/BBDukF.toValue):
``value = (canonical & middleMask) | lengthMask`` where canonical =
max(kmer, rc) when rcomp, middleMask clears the middle base when
maskMiddle, and lengthMask = 1<<(2*len) tags the k-mer length so short
(mink) tip k-mers coexist in one set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.bases import BASE_TO_NUMBER
from .build import reverse_complement_key


def length_mask(length: int) -> int:
    return 1 << (2 * length)


def middle_mask(k: int, mask_middle: bool) -> int:
    """reference: jgi/BBDukF.java:636."""
    return ~(3 << (2 * (k // 2))) if mask_middle else -1


def rolling_kmers_batch(bases: np.ndarray, k: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """All k-mers of each row: (B, L-k+1) int64 keys + validity mask.

    The reference's keys and mask, built in place: a window is valid when
    the running count of non-ACGT bases does not change across it, and the
    k shifts write into one array (a new (B, m) array a shift made the cut
    4x slower)."""
    B, L = bases.shape
    m = L - k + 1
    if m <= 0:
        return (np.zeros((B, 0), np.int64), np.zeros((B, 0), bool))
    codes = BASE_TO_NUMBER[bases]
    undefined = np.zeros((B, L + 1), np.int32)
    np.cumsum(codes < 0, axis=1, out=undefined[:, 1:])
    valid = undefined[:, k:] == undefined[:, :m]
    c3 = (codes & 3).astype(np.int64)
    keys = np.zeros((B, m), np.int64)
    for j in range(k):
        keys <<= 2
        keys |= c3[:, j:m + j]
    return keys, valid


def _hamming_mutants(kmers: np.ndarray, k: int) -> np.ndarray:
    """All 3k single-base mutants of each kmer (reference: BBDukF
    addToMap hdist expansion). Returns (N * 3k,) int64."""
    n = len(kmers)
    out = []
    for pos in range(k):
        shift = 2 * pos
        cur = (kmers >> shift) & 3
        for delta in (1, 2, 3):
            nb = (cur + delta) & 3
            out.append((kmers & ~(3 << shift)) | (nb << shift))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


@dataclass
class KmerSet:
    k: int
    mink: int
    mask_middle: bool
    rcomp: bool
    values: np.ndarray     # sorted int64
    ids: np.ndarray        # int32 scaffold/sequence id per value
    n_refs: int = 0
    ref_names: Optional[List[str]] = None
    # multi-id CSR (reference: kmer/HashArrayHybrid — the default
    # Seal/BBDuk table stores EVERY scaffold id owning a kmer, not
    # just the first; jgi/Seal.java:1713 map.set(key, id) appends).
    # Built when build_kmer_set(multi=True); ids[] then holds the
    # first (lowest) id per value for single-id consumers.
    multi_offsets: Optional[np.ndarray] = None   # int64 [n_values+1]
    multi_ids: Optional[np.ndarray] = None       # int32

    def to_values(self, kmers: np.ndarray, length: int) -> np.ndarray:
        """Raw kmers -> canonical masked values
        (reference: jgi/BBDukF.toValue)."""
        rk = reverse_complement_key(kmers, length)
        v = np.maximum(kmers, rk) if self.rcomp else kmers
        mm = middle_mask(length, self.mask_middle and length == self.k)
        return (v & mm) | length_mask(length)

    def contains(self, values: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.values, values)
        idx = np.minimum(idx, len(self.values) - 1)
        return (self.values[idx] == values) if len(self.values) else \
            np.zeros(values.shape, bool)

    def lookup_ids(self, values: np.ndarray) -> np.ndarray:
        """-1 where absent, else the sequence id of the matching value."""
        if len(self.values) == 0:
            return np.full(values.shape, -1, np.int32)
        idx = np.minimum(np.searchsorted(self.values, values),
                         len(self.values) - 1)
        hit = self.values[idx] == values
        return np.where(hit, self.ids[idx], -1).astype(np.int32)

    def lookup_slots(self, values: np.ndarray) -> np.ndarray:
        """-1 where absent, else the index into ``values`` (for
        multi-id expansion via ``multi_offsets``/``multi_ids``)."""
        if len(self.values) == 0:
            return np.full(values.shape, -1, np.int64)
        idx = np.minimum(np.searchsorted(self.values, values),
                         len(self.values) - 1)
        hit = self.values[idx] == values
        return np.where(hit, idx, -1)

    def expand_slots(self, rows: np.ndarray, slots: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(row, kmer-slot) hit pairs -> (row, scaffold-id) pairs with
        one entry per owning scaffold (multi-id tables), fully
        vectorized."""
        if self.multi_offsets is None:
            return rows, self.ids[slots].astype(np.int64)
        off = self.multi_offsets
        reps = (off[slots + 1] - off[slots]).astype(np.int64)
        total = int(reps.sum())
        starts = off[slots]
        # flat ranges: starts[i] .. starts[i]+reps[i] concatenated
        cum = np.zeros(len(reps) + 1, np.int64)
        np.cumsum(reps, out=cum[1:])
        flat = np.repeat(starts - cum[:-1], reps) + np.arange(total)
        return (np.repeat(rows, reps),
                self.multi_ids[flat].astype(np.int64))


def build_kmer_set(seqs: Sequence[bytes], k: int = 27, mink: int = 0,
                   hdist: int = 0, edist: int = 0, mask_middle: bool = True,
                   rcomp: bool = True,
                   names: Optional[List[str]] = None,
                   multi: bool = False) -> KmerSet:
    """Build the reference set from sequences (adapters/contaminants).

    hdist: hamming-distance expansion at build time (reference:
    jgi/BBDukF.addToMap:1785). mink>0 additionally inserts tip k-mers of
    lengths mink..k-1 from both ends of each sequence (short-kmer mode for
    adapter trimming, reference: BBDukF useShortKmers).
    """
    ks = KmerSet(k=k, mink=mink, mask_middle=mask_middle, rcomp=rcomp,
                 values=np.zeros(0, np.int64), ids=np.zeros(0, np.int32),
                 n_refs=len(seqs), ref_names=names)
    all_vals: List[np.ndarray] = []
    all_ids: List[np.ndarray] = []

    def add(vals: np.ndarray, sid: int):
        all_vals.append(vals)
        all_ids.append(np.full(len(vals), sid, np.int32))

    for sid, seq in enumerate(seqs):
        arr = np.frombuffer(seq, np.uint8) if isinstance(seq, bytes) else seq
        kmers, valid = rolling_kmers_batch(arr[None, :], k)
        kmers = kmers[0][valid[0]]
        if len(kmers):
            expanded = [kmers]
            frontier = kmers
            for _ in range(max(hdist, edist)):
                frontier = np.unique(_hamming_mutants(frontier, k))
                expanded.append(frontier)
            kk = np.unique(np.concatenate(expanded))
            add(ks.to_values(kk, k), sid)
        if mink > 0:
            L = len(arr)
            for length in range(mink, k):
                tips = []
                if L >= length:
                    km, v = rolling_kmers_batch(arr[None, :length], length)
                    if v[0].all():
                        tips.append(km[0])
                    km, v = rolling_kmers_batch(arr[None, L - length:],
                                                length)
                    if v[0].all():
                        tips.append(km[0])
                if tips:
                    tt = np.concatenate(tips)
                    exp = [tt]
                    frontier = tt
                    for _ in range(max(hdist, edist) if length > k // 2
                                   else 0):
                        frontier = np.unique(
                            _hamming_mutants(frontier, length))
                        exp.append(frontier)
                    add(ks.to_values(np.unique(np.concatenate(exp)),
                                     length), sid)
    if all_vals:
        vals = np.concatenate(all_vals)
        ids = np.concatenate(all_ids)
        order = np.argsort(vals, kind="stable")
        vals = vals[order]
        ids = ids[order]
        keep = np.ones(len(vals), bool)
        keep[1:] = vals[1:] != vals[:-1]
        if multi:
            # multi-id CSR: dedupe (value, id) pairs, keep every
            # distinct owner per value (reference HashArrayHybrid
            # set-semantics: one entry per (kmer, scaffold))
            pair_keep = np.ones(len(vals), bool)
            pair_keep[1:] = (vals[1:] != vals[:-1]) | \
                (ids[1:] != ids[:-1])
            pv, pi = vals[pair_keep], ids[pair_keep]
            first = np.ones(len(pv), bool)
            first[1:] = pv[1:] != pv[:-1]
            ks.values = pv[first]
            ks.ids = pi[first]
            counts = np.diff(np.append(np.nonzero(first)[0], len(pv)))
            ks.multi_offsets = np.zeros(len(ks.values) + 1, np.int64)
            np.cumsum(counts, out=ks.multi_offsets[1:])
            ks.multi_ids = pi.astype(np.int32)
        else:
            # dedupe keeping first (lowest sid wins, deterministic)
            ks.values = vals[keep]
            ks.ids = ids[keep]
    return ks


def scan_batch(ks: KmerSet, bases: np.ndarray, device
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Full-length k-mer scan: returns (hits (B, L-k+1) bool,
    ids (B, L-k+1) int32 with -1 for miss).

    Runs the torch scan (index/kmerset_device.py) on ``device`` for every
    batch; ``scan_batch_plain`` is the numpy reference it is held
    against."""
    from . import kmerset_device
    ids = kmerset_device.scan_ids(ks, bases, device)
    return (ids >= 0), ids


def scan_batch_plain(ks: KmerSet, bases: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """numpy reference of ``scan_batch``: rolling k-mers, canonical
    values, ``lookup_ids``."""
    kmers, valid = rolling_kmers_batch(bases, ks.k)
    if kmers.shape[1] == 0:
        return kmers.astype(bool), kmers.astype(np.int32)
    vals = ks.to_values(kmers, ks.k)
    ids = ks.lookup_ids(vals)
    ids[~valid] = -1
    return (ids >= 0), ids


def scan_batch_multi(ks: KmerSet, bases: np.ndarray, device
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-id scan: returns flat (rows (N,), ids (N,)) int64 pairs —
    one entry per (read k-mer hit x owning scaffold). With a multi-id
    table a k-mer shared by several scaffolds contributes one count to
    EACH (reference: jgi/Seal.java findBestMatch appends every stored
    id to countVector). The value slots come from the torch scan on
    ``device``; ``scan_batch_multi_plain`` is the numpy reference."""
    from . import kmerset_device
    return _expand_hits(ks, kmerset_device.scan_slots(ks, bases, device))


def scan_batch_multi_plain(ks: KmerSet, bases: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """numpy reference of ``scan_batch_multi`` (``lookup_slots``)."""
    kmers, valid = rolling_kmers_batch(bases, ks.k)
    if kmers.shape[1] == 0:
        z = np.zeros(0, np.int64)
        return z, z
    slots = ks.lookup_slots(ks.to_values(kmers, ks.k))
    slots[~valid] = -1
    return _expand_hits(ks, slots)


def _expand_hits(ks: KmerSet, slots: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, m) value slots (-1 miss) -> flat (row, scaffold-id) pairs."""
    B, m = slots.shape
    rows = np.repeat(np.arange(B, dtype=np.int64), m)
    flat = slots.ravel()
    hit = flat >= 0
    return ks.expand_slots(rows[hit], flat[hit])


def scan_tips(ks: KmerSet, bases: np.ndarray, lengths: np.ndarray,
              side: str) -> np.ndarray:
    """Short-kmer tip scan for ktrim with mink (reference: BBDukF
    useShortKmers). Returns (B,) int32: for side='r', the position from
    which a right-tip short k-mer matches (else -1); for side='l', the
    end position of a left-tip match (else -1)."""
    B, L = bases.shape
    out = np.full(B, -1, np.int32)
    for length in range(ks.k - 1, ks.mink - 1, -1):
        for i in range(B):
            Li = int(lengths[i])
            if Li < length:
                continue
            if side == "r":
                seg = bases[i, Li - length:Li]
            else:
                seg = bases[i, :length]
            km, valid = rolling_kmers_batch(seg[None, :], length)
            if km.shape[1] and valid[0, 0]:
                v = ks.to_values(km[:, :1], length)
                if ks.contains(v)[0]:
                    if side == "r":
                        out[i] = Li - length
                    else:
                        out[i] = length
    return out
