"""K>31 k-mer support (31 < K <= 62): keys as (hi, lo) int64 pairs.

reference: ukmer/ package — Kmer.java holds K>31 k-mers as long[]
(KmerTableSetU.java:243-251); here the two-word representation keeps
numpy vectorization (lexsort-based counting replaces HashArrayU tables).
hi holds the first K-31 bases, lo the last 31 (2-bit big-endian each).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.bases import BASE_TO_NUMBER
from .build import reverse_complement_key

LO_BASES = 31


def rolling_kmers_big(bases: np.ndarray, k: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(B, L) ASCII -> (hi, lo) int64 (B, L-k+1) + valid mask."""
    assert LO_BASES < k <= 62
    nh = k - LO_BASES
    B, L = bases.shape
    m = L - k + 1
    if m <= 0:
        z = np.zeros((B, 0), np.int64)
        return z, z, np.zeros((B, 0), bool)
    c = BASE_TO_NUMBER[bases].astype(np.int64)
    hi = np.zeros((B, m), np.int64)
    lo = np.zeros((B, m), np.int64)
    bad = np.zeros((B, m), bool)
    for j in range(nh):
        col = c[:, j:m + j]
        bad |= col < 0
        hi = (hi << 2) | (col & 3)
    for j in range(nh, k):
        col = c[:, j:m + j]
        bad |= col < 0
        lo = (lo << 2) | (col & 3)
    return hi, lo, ~bad


def rc_big(hi: np.ndarray, lo: np.ndarray, k: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Reverse complement of (hi, lo) pairs."""
    nh = k - LO_BASES
    rl = reverse_complement_key(lo, LO_BASES)   # 31 bases
    rh = reverse_complement_key(hi, nh)         # nh bases
    # rc sequence = rl (31 bases) then rh (nh bases)
    shift = 2 * (LO_BASES - nh)
    hi2 = rl >> shift
    lo2 = ((rl & ((1 << shift) - 1)) << (2 * nh)) | rh
    return hi2, lo2


def canonical_big(hi: np.ndarray, lo: np.ndarray, k: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    h2, l2 = rc_big(hi, lo, k)
    take_rc = (h2 < hi) | ((h2 == hi) & (l2 < lo))
    return np.where(take_rc, h2, hi), np.where(take_rc, l2, lo)


class KmerCounterBig:
    """Sorted-pair exact counter for K>31 (the KmerTableSetU analog)."""

    def __init__(self, k: int, canonical: bool = True,
                 chunk_kmers: int = 16_000_000):
        assert LO_BASES < k <= 62
        self.k = k
        self.canonical = canonical
        self.chunk_kmers = chunk_kmers
        self._pending: List[Tuple[np.ndarray, np.ndarray]] = []
        self._pending_n = 0
        self._hi = np.zeros(0, np.int64)
        self._lo = np.zeros(0, np.int64)
        self._counts = np.zeros(0, np.int64)

    def add_batch(self, bases: np.ndarray) -> None:
        hi, lo, valid = rolling_kmers_big(bases, self.k)
        h, l = hi[valid], lo[valid]
        if self.canonical and len(h):
            h, l = canonical_big(h, l, self.k)
        if len(h):
            self._pending.append((h, l))
            self._pending_n += len(h)
        if self._pending_n >= self.chunk_kmers:
            self._merge()

    def _merge(self) -> None:
        if not self._pending:
            return
        h = np.concatenate([p[0] for p in self._pending] + [self._hi])
        l = np.concatenate([p[1] for p in self._pending] + [self._lo])
        w = np.concatenate(
            [np.ones(self._pending_n, np.int64), self._counts])
        self._pending = []
        self._pending_n = 0
        order = np.lexsort((l, h))
        h, l, w = h[order], l[order], w[order]
        new = np.ones(len(h), bool)
        new[1:] = (h[1:] != h[:-1]) | (l[1:] != l[:-1])
        grp = np.cumsum(new) - 1
        counts = np.bincount(grp, weights=w).astype(np.int64)
        self._hi, self._lo, self._counts = h[new], l[new], counts

    def finish(self):
        self._merge()
        return self._hi, self._lo, self._counts

    def histogram(self, max_count: int = 100000) -> np.ndarray:
        _, _, counts = self.finish()
        return np.bincount(np.minimum(counts, max_count),
                           minlength=max_count + 1)


def big_kmer_to_str(hi: int, lo: int, k: int) -> str:
    nh = k - LO_BASES
    table = "ACGT"
    out = []
    for j in range(nh - 1, -1, -1):
        out.append(table[(hi >> (2 * j)) & 3])
    for j in range(LO_BASES - 1, -1, -1):
        out.append(table[(lo >> (2 * j)) & 3])
    return "".join(out)
