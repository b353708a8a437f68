"""Batched read representation: structure-of-arrays over padded reads.

Replaces the reference's object-per-read model (reference:
stream/Read.java) with fixed-shape arrays fit for device compute: bases as
ASCII uint8 padded with 'N', qualities as phred int8, plus host-side ids.
Batches are the unit of pipeline flow, like the reference's
``ListNum<Read>`` lists of 200 reads (reference: align2/Shared.java:12-14).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..io.fastx import ASCII_OFFSET, SeqRecord
from . import bases as B


@dataclass
class ReadBatch:
    bases: np.ndarray          # (B, Lmax) uint8 ASCII, padded with 'N'
    quality: Optional[np.ndarray]  # (B, Lmax) int8 phred, padded with 0
    lengths: np.ndarray        # (B,) int32
    ids: List[str]
    numeric_ids: np.ndarray    # (B,) int64
    mate: Optional["ReadBatch"] = None  # read-2 batch for paired input

    @property
    def size(self) -> int:
        return len(self.lengths)

    @property
    def lmax(self) -> int:
        return self.bases.shape[1]

    def bases_rc(self) -> np.ndarray:
        """Reverse-complement each read within its own length (padding stays
        at the tail)."""
        out = np.full_like(self.bases, ord("N"))
        for i, L in enumerate(self.lengths):
            out[i, :L] = B.COMP_ASCII[self.bases[i, :L][::-1]]
        return out

    @classmethod
    def from_records(cls, records: Sequence[SeqRecord],
                     lmax: Optional[int] = None) -> "ReadBatch":
        n = len(records)
        if lmax is None:
            lmax = max((len(r.bases) for r in records), default=0)
        # fast path: uniform-length records decode via one bulk frombuffer
        if n and all(len(r.bases) == lmax for r in records):
            bases = B.clean_ascii(np.frombuffer(
                b"".join(r.bases for r in records),
                np.uint8).reshape(n, lmax).copy())
            lengths = np.full(n, lmax, np.int32)
            ids = [r.id for r in records]
            nids = np.fromiter((r.numeric_id for r in records), np.int64,
                               n)
            qual = None
            if records[0].quality is not None and all(
                    r.quality is not None and len(r.quality) == lmax
                    for r in records):
                qual = (np.frombuffer(
                    b"".join(r.quality for r in records), np.uint8)
                    .reshape(n, lmax).astype(np.int16)
                    - ASCII_OFFSET).astype(np.int8)
            return cls(bases=bases, quality=qual, lengths=lengths,
                       ids=ids, numeric_ids=nids)
        bases = np.full((n, lmax), ord("N"), np.uint8)
        qual = np.zeros((n, lmax), np.int8)
        lengths = np.zeros(n, np.int32)
        ids = []
        nids = np.zeros(n, np.int64)
        has_qual = False
        for i, r in enumerate(records):
            L = min(len(r.bases), lmax)
            arr = B.clean_ascii(np.frombuffer(r.bases, np.uint8)[:L])
            bases[i, :L] = arr
            lengths[i] = L
            ids.append(r.id)
            nids[i] = r.numeric_id
            if r.quality is not None:
                has_qual = True
                qual[i, :L] = (np.frombuffer(r.quality, np.uint8)[:L]
                               .astype(np.int16) - ASCII_OFFSET).astype(
                                   np.int8)
        return cls(bases=bases, quality=qual if has_qual else None,
                   lengths=lengths, ids=ids, numeric_ids=nids)


def batched(iterator, batch_size: int = 4096):
    """Group an iterator of SeqRecords (or pairs) into lists."""
    buf = []
    for item in iterator:
        buf.append(item)
        if len(buf) >= batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def prefetch(iterator, depth: int = 2):
    """Run `iterator` in a background thread with a bounded queue, so
    input decode overlaps downstream compute (the reference's
    producer/consumer read-stream overlap, reference:
    stream/ConcurrentGenericReadInputStream.java:122-166; VERDICT r1
    next-step #6). Exceptions propagate to the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _DONE = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(_DONE)
        except BaseException as e:  # propagate into the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _DONE:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
