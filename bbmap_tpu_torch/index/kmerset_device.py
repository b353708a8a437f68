"""The k-mer set scan of bbduk, bbduk2 and seal as torch tensor code on
one device: the port of the JAX package's ``index/kmerset_device.py``
(its ``DeviceKmerSet.scan_ids`` and ``device_scan_counts``).

For every read position of a (B, L) batch:

1. the rolling 2-bit k-mer and its reverse complement, one ``int64``
   each, built from k shifted slices of the batch's base codes (no
   gathers); a window holding a base that is not ACGT/U is invalid;
2. the canonical value, ``max(kmer, rc)`` when the set is rcomp, the
   middle-base mask and the length bit ``1 << 2k`` — bit for bit the host
   ``KmerSet.to_values`` (reference ``jgi/BBDukF.toValue``). The length
   bit is at most bit 62, so every value is below 2**63 and signed order
   is the values' order;
3. a lower bound over the set's sorted values (``torch.searchsorted``)
   and an equality probe: the value's slot, or -1.

``scan_ids`` gives per-position sequence ids (bbduk, bbduk2),
``scan_slots`` the slots (seal's multi-owner route, expanded on the host
by ``KmerSet.expand_slots``), and ``device_scan_counts`` sums each
read's owner rows of a (slots + 1, nrefs) uint8 owner matrix into the
(B, nrefs) hit counts seal condenses, clipped to 65,535 as the
reference's ``uint16`` result is.

The numpy search of ``kmerset.py`` (``scan_batch_plain``,
``scan_batch_multi_plain``) and ``count_hits_plain`` here are the plain
versions these are held against. Every entry point runs on the device it
is given, for every batch size: 'cuda' without a card raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import backend
from ..core.bases import BASE_TO_NUMBER
from .kmerset import KmerSet, length_mask, middle_mask

# seal's count route: past these the owner matrix is not built and seal
# takes the slot route (reference kmerset_device.py:445-449)
COUNTS_MAX_REFS = 4096
OWNER_MATRIX_MAX_BYTES = 256 << 20
COUNT_MAX = 65535
# read positions one gather of owner rows takes, so that the
# (B, positions, nrefs) block stays a few hundred MB at seal's chunk size
COUNT_POSITIONS = 8

ROUTES = ("ids", "slots", "counts")
# scans run since the last reset_scans(), by route: "ids" (scan_ids:
# bbduk, bbduk2), "slots" (scan_slots: seal past the count route's
# gates) and "counts" (device_scan_counts: seal)
scans: Dict[str, int] = {}


def reset_scans() -> None:
    scans.update(dict.fromkeys(ROUTES, 0))


reset_scans()


class DeviceKmerSet:
    """A host ``KmerSet``'s sorted values and ids on one device."""

    def __init__(self, ks: KmerSet, device):
        self.device = backend.resolve_device(device)
        self.k = ks.k
        self.rcomp = ks.rcomp
        self.n = len(ks.values)
        self.values = torch.from_numpy(
            np.ascontiguousarray(ks.values, np.int64)).to(self.device)
        self.ids = torch.from_numpy(
            np.ascontiguousarray(ks.ids, np.int32)).to(self.device)
        self.codes = torch.from_numpy(
            BASE_TO_NUMBER.astype(np.int64)).to(self.device)
        self.middle = middle_mask(ks.k, ks.mask_middle)
        self.owner: Dict[int, torch.Tensor] = {}

    def canonical_values(self, bases: np.ndarray):
        """(B, L) ASCII -> ((B, m) int64 canonical values, (B, m) bool
        validity); m = L - k + 1 >= 1."""
        k = self.k
        x = torch.from_numpy(np.ascontiguousarray(bases, np.uint8)).to(
            self.device)
        B, L = x.shape
        m = L - k + 1
        c = self.codes[x.long()]
        undefined = torch.zeros((B, L + 1), dtype=torch.int32,
                                device=self.device)
        undefined[:, 1:] = torch.cumsum(c < 0, dim=1, dtype=torch.int32)
        valid = undefined[:, k:] == undefined[:, :m]
        c &= 3
        fwd = torch.zeros((B, m), dtype=torch.int64, device=self.device)
        rc = torch.zeros_like(fwd) if self.rcomp else None
        for j in range(k):
            cj = c[:, j:j + m]
            fwd.bitwise_left_shift_(2).bitwise_or_(cj)
            if rc is not None:
                # the complement (3 - code) of base j lands in group j
                rc.bitwise_or_((3 - cj).bitwise_left_shift_(2 * j))
        v = torch.maximum(fwd, rc) if rc is not None else fwd
        if self.middle != -1:
            v &= torch.tensor(self.middle, dtype=torch.int64,
                              device=self.device)
        v |= length_mask(k)
        return v, valid

    def slots(self, bases: np.ndarray) -> torch.Tensor:
        """(B, L) ASCII -> (B, m) int64 slot of each position's value in
        the sorted values, -1 for a miss or an invalid window."""
        B, L = bases.shape
        m = max(L - self.k + 1, 0)
        if m == 0 or self.n == 0:
            return torch.full((B, m), -1, dtype=torch.int64,
                              device=self.device)
        v, valid = self.canonical_values(bases)
        pos = torch.searchsorted(self.values, v).clamp_(max=self.n - 1)
        hit = valid & (self.values[pos] == v)
        return torch.where(hit, pos, -1)

    def owner_matrix(self, ks: KmerSet, nrefs: int) -> torch.Tensor:
        """(n + 1, nrefs) uint8: row s marks the sequences owning slot s
        (every owner of a multi-id set); row n, a miss's, is zero. Built
        on the host as the reference builds it, then kept here."""
        own = self.owner.get(nrefs)
        if own is None:
            n = self.n
            om = np.zeros((n + 1, nrefs), np.uint8)
            if ks.multi_offsets is not None:
                reps = np.diff(ks.multi_offsets).astype(np.int64)
                slot_of = np.repeat(np.arange(n), reps)
                om[slot_of, ks.multi_ids[:int(reps.sum())]] = 1
            else:
                om[np.arange(n), np.clip(ks.ids, 0, nrefs - 1)] = 1
            own = self.owner[nrefs] = torch.from_numpy(om).to(self.device)
        return own


def device_set(ks: KmerSet, device) -> DeviceKmerSet:
    """The set's DeviceKmerSet on ``device``, built once and cached on
    the KmerSet."""
    dev = backend.resolve_device(device)
    cache = ks.__dict__.setdefault("_device_sets", {})
    dks = cache.get(dev)
    if dks is None:
        dks = cache[dev] = DeviceKmerSet(ks, dev)
    return dks


def scan_ids(ks: KmerSet, bases: np.ndarray, device) -> np.ndarray:
    """(B, L) ASCII -> (B, L-k+1) int32 sequence ids, -1 for a miss or
    an invalid window: ``kmerset.scan_batch_plain``'s ids, computed on
    ``device``."""
    dks = device_set(ks, device)
    slot = dks.slots(bases)
    scans["ids"] += 1
    if dks.n == 0:
        return slot.to(torch.int32).cpu().numpy()
    ids = torch.where(slot >= 0, dks.ids[slot.clamp(min=0)], -1)
    return ids.to(torch.int32).cpu().numpy()


def scan_slots(ks: KmerSet, bases: np.ndarray, device) -> np.ndarray:
    """(B, L) ASCII -> (B, L-k+1) int64 value slots (-1 miss), computed
    on ``device``; ``KmerSet.expand_slots`` turns hits into owners."""
    slot = device_set(ks, device).slots(bases)
    scans["slots"] += 1
    return slot.cpu().numpy()


def device_scan_counts(ks: KmerSet, bases: np.ndarray, nrefs: int,
                       device) -> Optional[np.ndarray]:
    """(B, L) ASCII -> (B, nrefs) int64 hit counts per read and owning
    sequence, clipped to 65,535, computed on ``device``: each position's
    slot selects an owner row, and the rows are summed over the positions
    ``COUNT_POSITIONS`` at a time. None past the count route's gates
    (more than ``COUNTS_MAX_REFS`` sequences, or an owner matrix over
    ``OWNER_MATRIX_MAX_BYTES``): the caller takes the slot route."""
    n = len(ks.values)
    if nrefs > COUNTS_MAX_REFS or (n + 1) * nrefs > OWNER_MATRIX_MAX_BYTES:
        return None
    dks = device_set(ks, device)
    slot = dks.slots(bases)
    scans["counts"] += 1
    B, m = slot.shape
    counts = torch.zeros((B, nrefs), dtype=torch.int32, device=dks.device)
    if m and n:
        own = dks.owner_matrix(ks, nrefs)
        slot = torch.where(slot >= 0, slot, n)
        for g in range(0, m, COUNT_POSITIONS):
            counts += own[slot[:, g:g + COUNT_POSITIONS]].sum(
                dim=1, dtype=torch.int32)
    return counts.clamp_(max=COUNT_MAX).cpu().numpy().astype(np.int64)


def count_hits_plain(ks: KmerSet, bases: np.ndarray,
                     nrefs: int) -> np.ndarray:
    """numpy reference of ``device_scan_counts``: the (row, owner) pairs
    of ``scan_batch_multi_plain`` counted into (B, nrefs), clipped."""
    from .kmerset import scan_batch_multi_plain
    rows, ids = scan_batch_multi_plain(ks, bases)
    B = bases.shape[0]
    counts = np.bincount(rows * nrefs + ids, minlength=B * nrefs)
    return np.minimum(counts.reshape(B, nrefs), COUNT_MAX).astype(np.int64)
