"""Carry state built by the JAX package ``bbmap_tpu`` into the port's own
classes.

The port keeps its own copies of the host modules, so a ``Genome``,
``KmerIndex``, ``ReadBatch``, ``ScoringProfile`` or ``KmerSet`` of the
reference is a different class from the port's. The functions here read
a reference object by its fields (duck typing: this module does not
import ``bbmap_tpu``) and return the port's object holding the same
numpy arrays and plain values. Arrays are shared, not copied: neither package writes
into them after they are built. The parity tests use these wherever they
hand reference state to the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .core.batch import ReadBatch
from .core.constants import ScoringProfile
from .core.genome import Genome, Scaffold
from .index.build import KmerIndex
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
