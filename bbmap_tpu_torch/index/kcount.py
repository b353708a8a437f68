"""Probabilistic k-mer counter (counting Bloom filter / count-min sketch).

reference: bloom/KCountArray.java + KCountArray7MTA.java:27 — atomic
packed-cell counting Bloom filter with multiple hashes and optional
prefilter. Here: flat numpy cell arrays with vectorized multi-hash
scatter-add (np.add.at) — the same HBM-resident layout a device
scatter-add kernel uses (SURVEY.md §2.7 'TPU equivalent: HBM-resident
packed counter arrays with vectorized multi-hash scatter-add').

Counts are capped at cell_max on read (count-min over the hash functions),
matching the reference's saturating packed cells.

The port's copy: ``KCountArray`` and ``_mix`` are the JAX package's numpy
class and hash, kept as the plain reference. ``DeviceKCountArray`` holds
its counter rows as a torch tensor on one device and saturates each row at
``cell_max`` after every scatter-add, so its rows equal the numpy class's
at every depth (the JAX package's device class adds without clamping).
``make_kca`` builds it on the device it is given.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import backend

_MASKS = [
    0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
    0x27D4EB2F165667C5, 0xFF51AFD7ED558CCD, 0xC4CEB9FE1A85EC53,
]


def _mix(x: np.ndarray, salt: int) -> np.ndarray:
    """64-bit mix (splitmix-style) for hashing kmers to cells."""
    x = (x.astype(np.uint64) * np.uint64(salt)) & np.uint64(2**64 - 1)
    x ^= x >> np.uint64(33)
    x = (x * np.uint64(0xFF51AFD7ED558CCD)) & np.uint64(2**64 - 1)
    x ^= x >> np.uint64(29)
    return x


class KCountArray:
    def __init__(self, cells: int, cell_bits: int = 16, hashes: int = 1):
        assert cell_bits in (2, 4, 8, 16, 32)
        self.cells = 1 << int(cells).bit_length() if cells & (cells - 1) \
            else cells
        self.mask = self.cells - 1
        self.cell_bits = cell_bits
        self.cell_max = (1 << cell_bits) - 1
        self.hashes = hashes
        dtype = (np.uint8 if cell_bits <= 8 else
                 np.uint16 if cell_bits == 16 else np.uint32)
        self.array = np.zeros((hashes, self.cells), dtype)
        self._acc_dtype = np.uint32

    def _idx(self, kmers: np.ndarray, h: int) -> np.ndarray:
        return (_mix(kmers, _MASKS[h % len(_MASKS)])
                & np.uint64(self.mask)).astype(np.int64)

    def increment(self, kmers: np.ndarray) -> None:
        """Vectorized multi-hash scatter-add with saturation."""
        for h in range(self.hashes):
            idx = self._idx(kmers, h)
            row = self.array[h]
            # saturating add: accumulate deltas in a wide dtype first
            deltas = np.bincount(idx, minlength=self.cells)
            nz = np.nonzero(deltas)[0]
            cur = row[nz].astype(np.int64)
            row[nz] = np.minimum(cur + deltas[nz],
                                 self.cell_max).astype(row.dtype)

    def read(self, kmers: np.ndarray) -> np.ndarray:
        """count-min over hash functions."""
        out = None
        for h in range(self.hashes):
            v = self.array[h][self._idx(kmers, h)].astype(np.int32)
            out = v if out is None else np.minimum(out, v)
        return out if out is not None else np.zeros(len(kmers), np.int32)

    def used_fraction(self) -> float:
        return float((self.array[0] != 0).mean())


def _signed(v: int) -> int:
    """A 64-bit pattern as the int64 that holds it."""
    return v - (1 << 64) if v >= 1 << 63 else v


# _mix's multipliers as int64 patterns: torch's int64 multiply wraps mod
# 2**64, the same bits as numpy's uint64 product
_SALTS = [_signed(m) for m in _MASKS]
_FINAL = _signed(0xFF51AFD7ED558CCD)

ROUTES = ("increment", "read")
# DeviceKCountArray calls since the last reset_calls(), by route
calls: Dict[str, int] = {}


def reset_calls() -> None:
    calls.update(dict.fromkeys(ROUTES, 0))


reset_calls()


class DeviceKCountArray:
    """Counting Bloom filter with its counter rows on one torch device —
    the port of the JAX package's device class (reference:
    bloom/KCountArray7MTA.java:27; SURVEY §2.7/§2.11 P8: 'HBM-resident
    packed counter arrays with vectorized multi-hash scatter-add').

    ``array`` is a (hashes, cells) tensor on ``device``: int32, or int64
    at ``cell_bits=32``, whose ``cell_max`` does not fit int32. A call
    hashes its k-mers for every row at once into (hashes, N) indices of
    the flattened rows. ``increment`` is one ``index_add_`` of ones over
    them (integer adds with repeated indices are deterministic) and a clamp
    of the rows to ``cell_max``, the numpy class's saturating add; ``read``
    is a count-min gather, clipped to ``cell_max``, as int32. The hash is
    ``_mix`` in int64 arithmetic: the multiplies wrap as uint64's do, and
    each right shift, arithmetic in torch, is masked to the bits a logical
    shift leaves. So rows, reads and ``used_fraction`` equal the numpy
    class's for the same k-mers."""

    def __init__(self, cells: int, cell_bits: int = 16, hashes: int = 1,
                 *, device):
        assert cell_bits in (2, 4, 8, 16, 32)
        self.device = backend.resolve_device(device)
        self.cells = 1 << int(cells).bit_length() \
            if cells & (cells - 1) else cells
        self.mask = self.cells - 1
        self.cell_bits = cell_bits
        self.cell_max = (1 << cell_bits) - 1
        self.hashes = hashes
        dtype = torch.int64 if cell_bits == 32 else torch.int32
        self.array = torch.zeros((hashes, self.cells), dtype=dtype,
                                 device=self.device)
        # each row's salt, and the row's first cell in the flattened rows
        self._salts = torch.tensor(
            [_SALTS[h % len(_SALTS)] for h in range(hashes)],
            dtype=torch.int64, device=self.device)[:, None]
        self._rows = torch.arange(hashes, dtype=torch.int64,
                                  device=self.device)[:, None] * self.cells

    @staticmethod
    def _mix_int64(x: torch.Tensor, salt) -> torch.Tensor:
        """``_mix`` of int64 k-mers by ``salt`` (an int64 pattern, or a
        column of them), as int64 bits."""
        x = x * salt
        x ^= (x >> 33) & ((1 << 31) - 1)
        x *= _FINAL
        x ^= (x >> 29) & ((1 << 35) - 1)
        return x

    def _idx(self, kmers: np.ndarray) -> torch.Tensor:
        """(hashes, N) indices of the k-mers' cells in the flattened
        rows."""
        x = torch.from_numpy(np.ascontiguousarray(kmers, np.int64)).to(
            self.device)
        return (self._mix_int64(x[None, :], self._salts) & self.mask) \
            + self._rows

    def increment(self, kmers: np.ndarray) -> None:
        """Count each k-mer (int64 >= 0) once in every hash row,
        saturating at ``cell_max``."""
        calls["increment"] += 1
        if not len(kmers):
            return
        idx = self._idx(kmers).view(-1)
        self.array.view(-1).index_add_(
            0, idx, torch.ones(len(idx), dtype=self.array.dtype,
                               device=self.device))
        self.array.clamp_(max=self.cell_max)

    def read(self, kmers: np.ndarray) -> np.ndarray:
        """Count-min over the hash rows, as numpy int32."""
        calls["read"] += 1
        if not len(kmers):
            return np.zeros(0, np.int32)
        counts = self.array.view(-1)[self._idx(kmers)].amin(dim=0)
        return counts.clamp_(max=self.cell_max).to(torch.int32).cpu().numpy()

    def used_fraction(self) -> float:
        """Share of row 0's cells that are not zero, from an exact count."""
        return int(torch.count_nonzero(self.array[0])) / self.cells


def make_kca(cells: int, cell_bits: int = 16, hashes: int = 1, *,
             device) -> DeviceKCountArray:
    """The counting Bloom filter on ``device`` ('cuda' needs a card)."""
    return DeviceKCountArray(cells, cell_bits=cell_bits, hashes=hashes,
                             device=device)
