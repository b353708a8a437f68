"""Carry state built by the JAX package ``bbmap_tpu`` into the port's own
classes.

The port keeps its own copies of the host modules, so a ``Genome``,
``KmerIndex``, ``ReadBatch``, ``ScoringProfile``, ``KmerSet`` or
counting Bloom filter of the reference is a different class from the
port's. The functions here read
a reference object by its fields (duck typing: this module does not
import ``bbmap_tpu``) and return the port's object holding the same
numpy arrays and plain values. Arrays are shared, not copied: neither package writes
into them after they are built. The counting Bloom filter is the
exception: its rows are copied onto the port's device, where it counts
on. The parity tests use these wherever they
hand reference state to the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .core.batch import ReadBatch
from .core.constants import ScoringProfile
from .core.genome import Genome, Scaffold
from .index.build import KmerIndex
from .index.kcount import DeviceKCountArray
from .index.kmerset import KmerSet


def _fields(cls, obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def genome(ref) -> Genome:
    """The port's Genome with the reference's chroms, scaffolds, names and
    the derived tables of ``finalize()`` as they stand."""
    kw = _fields(Genome, ref)
    kw["scaffolds"] = [Scaffold(**_fields(Scaffold, s))
                       for s in ref.scaffolds]
    for name in ("chroms", "chrom_code", "_scaf_starts", "_scaf_index"):
        kw[name] = list(kw[name])
    return Genome(**kw)


def index(ref) -> KmerIndex:
    """The port's KmerIndex with the reference's ``starts`` / ``sites`` /
    genome codes / offsets, canonical counts and the analysis fields
    (usable-length thresholds, histogram, trim limits)."""
    return KmerIndex(**_fields(KmerIndex, ref))


def read_batch(ref) -> Optional[ReadBatch]:
    """The port's ReadBatch with the reference's columns; a mate batch is
    carried across too."""
    if ref is None:
        return None
    kw = _fields(ReadBatch, ref)
    kw["ids"] = list(kw["ids"])
    kw["mate"] = read_batch(ref.mate)
    return ReadBatch(**kw)


def profile(ref) -> ScoringProfile:
    """The port's ScoringProfile with the reference's fields."""
    return ScoringProfile(**{f: getattr(ref, f)
                             for f in ScoringProfile._fields})


def kmer_set(ref) -> KmerSet:
    """The port's KmerSet with the reference's sorted values and ids,
    k / mink / mask_middle / rcomp, sequence count and names, and the
    multi-owner CSR (``multi_offsets``, ``multi_ids``) where it has one."""
    kw = _fields(KmerSet, ref)
    if kw["ref_names"] is not None:
        kw["ref_names"] = list(kw["ref_names"])
    return KmerSet(**kw)


def kca(ref, device) -> DeviceKCountArray:
    """The port's counting Bloom filter on ``device`` holding the counter
    rows of a reference ``KCountArray`` (numpy rows) or
    ``DeviceKCountArray`` (its rows fetched as numpy), with the same
    cells, cell bits and hashes. Rows are clipped to ``cell_max``: the
    reference's device class adds without saturating, and the port's rows
    hold saturated counts as its numpy class does."""
    out = DeviceKCountArray(ref.cells, cell_bits=ref.cell_bits,
                            hashes=ref.hashes, device=device)
    rows = np.minimum(np.asarray(ref.array).astype(np.int64), ref.cell_max)
    out.array.copy_(torch.from_numpy(rows))
    return out
