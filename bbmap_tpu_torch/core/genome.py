"""Packed genome: scaffolds merged into padded chrom blocks + scaffold table.

Replaces the reference's genome registry and fasta packer
(reference: dna/Data.java, dna/FastaToChromArrays2.java:24). Exact padding
semantics are preserved because they define SAM coordinates:

- each chrom starts with START_PADDING (8000) Ns
  (reference: dna/FastaToChromArrays2.java:436-438,569)
- scaffolds within a chrom are separated by MID_PADDING (300) Ns (:463-467,570)
- the chrom is extended until it has END_PADDING+1 trailing Ns (:490-503,571)
- a new chrom starts when the next scaffold would exceed MAX_LENGTH (:461)
- characters are uppercased, non-IUPAC -> 'N'
  (reference: dna/ChromosomeArray.java:118-123)

The packed representation is a single concatenated uint8 code array (0..3 =
ACGT, 4 = undefined) plus int64 chrom offsets — the device-side layout for
index build and alignment gathers.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core import bases as B
from ..io import fastx

START_PADDING = 8000
MID_PADDING = 300
END_PADDING = 8000
MAX_LENGTH = (1 << 29) - 200000
MIN_SCAFFOLD = 1


@dataclass
class Scaffold:
    chrom: int        # 1-based chrom block id
    sid: int          # 1-based global scaffold id
    start: int        # offset of scaffold base 0 within its chrom array
    length: int
    name: str


@dataclass
class Genome:
    """In-memory packed genome (the reference's Data registry,
    dna/Data.java, as plain arrays)."""

    chroms: List[np.ndarray] = field(default_factory=list)  # ASCII uint8 each
    scaffolds: List[Scaffold] = field(default_factory=list)
    name: str = ""
    source: str = ""

    # --- derived, built by finalize() ---
    chrom_code: List[np.ndarray] = field(default_factory=list)
    # per-chrom scaffold partition for coordinate translation
    _scaf_starts: List[np.ndarray] = field(default_factory=list)
    _scaf_index: List[np.ndarray] = field(default_factory=list)

    @property
    def n_chroms(self) -> int:
        return len(self.chroms)

    def finalize(self) -> "Genome":
        self.chrom_code = [B.to_codes(c) for c in self.chroms]
        self._scaf_starts = []
        self._scaf_index = []
        per_chrom: List[List[Scaffold]] = [[] for _ in range(self.n_chroms)]
        for s in self.scaffolds:
            per_chrom[s.chrom - 1].append(s)
        for lst in per_chrom:
            self._scaf_starts.append(
                np.array([s.start for s in lst], np.int64))
            self._scaf_index.append(
                np.array([s.sid - 1 for s in lst], np.int64))
        return self

    # --- coordinate translation (reference: dna/Data scaffold tables &
    # stream/SamLine.java pos computation) ---
    def locate(self, chrom: int, loc: int) -> Tuple[Scaffold, int]:
        """(chrom block, 0-based loc) -> (scaffold, 0-based offset in it).
        Positions in inter-scaffold padding attach to the nearest preceding
        scaffold (offset may be negative for positions before scaffold 1)."""
        starts = self._scaf_starts[chrom - 1]
        i = int(np.searchsorted(starts, loc, side="right")) - 1
        i = max(0, i)
        scaf = self.scaffolds[int(self._scaf_index[chrom - 1][i])]
        return scaf, loc - scaf.start

    def total_bases(self) -> int:
        return sum(len(c) for c in self.chroms)

    def defined_bases(self) -> int:
        return int(sum(int((c != ord("N")).sum()) for c in self.chroms))

    # --- flat device layout ---
    def packed_codes(self) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenate all chrom code arrays; returns (codes, offsets) where
        offsets[c] is the flat position of chrom c+1's base 0 and
        offsets[-1] the total length."""
        offsets = np.zeros(self.n_chroms + 1, np.int64)
        for i, c in enumerate(self.chrom_code):
            offsets[i + 1] = offsets[i] + len(c)
        if self.n_chroms:
            codes = np.concatenate(self.chrom_code)
        else:
            codes = np.zeros(0, np.uint8)
        return codes, offsets


def build_genome(fasta_path: str, name: str = "",
                 start_pad: int = START_PADDING, mid_pad: int = MID_PADDING,
                 end_pad: int = END_PADDING,
                 min_scaffold: int = MIN_SCAFFOLD,
                 merge_scaffolds: bool = True,
                 max_length: int = MAX_LENGTH) -> Genome:
    """Stream a fasta into padded chrom arrays + scaffold table
    (reference: dna/FastaToChromArrays2.java:330-525)."""
    g = Genome(name=name or os.path.basename(fasta_path), source=fasta_path)
    chrom_parts: List[np.ndarray] = []
    chrom_len = 0
    chrom_id = 1
    scaffolds_in_chrom = 0
    sid = 0

    def finish_chrom():
        nonlocal chrom_parts, chrom_len, chrom_id, scaffolds_in_chrom
        if scaffolds_in_chrom == 0:
            chrom_parts, chrom_len = [], 0
            return
        arr = np.concatenate(chrom_parts) if chrom_parts else np.zeros(0, np.uint8)
        # end padding: extend until END_PADDING+1 trailing Ns
        # (reference: dna/FastaToChromArrays2.java:490-503 — the while loop
        # runs while terminalN<=END_PADDING, so the final count is
        # END_PADDING+1 when any extension happens)
        if end_pad > 0:
            terminal = 0
            for i in range(len(arr) - 1, -1, -1):
                if arr[i] == ord("N") and terminal < end_pad:
                    terminal += 1
                else:
                    break
            add = max(0, end_pad + 1 - terminal)
            if add and len(arr) + add <= max_length:
                arr = np.concatenate(
                    [arr, np.full(add, ord("N"), np.uint8)])
        g.chroms.append(arr)
        chrom_parts, chrom_len = [], 0
        chrom_id += 1
        scaffolds_in_chrom = 0

    for rec in fastx.read_fasta(fasta_path):
        seq = B.clean_ascii(np.frombuffer(rec.bases, np.uint8))
        if len(seq) < min_scaffold:
            continue
        if scaffolds_in_chrom > 0 and (
                not merge_scaffolds
                or chrom_len + mid_pad + len(seq) + end_pad > max_length):
            finish_chrom()
        if scaffolds_in_chrom == 0:
            chrom_parts.append(np.full(start_pad, ord("N"), np.uint8))
            chrom_len = start_pad
        else:
            chrom_parts.append(np.full(mid_pad, ord("N"), np.uint8))
            chrom_len += mid_pad
        sid += 1
        g.scaffolds.append(
            Scaffold(chrom_id, sid, chrom_len, len(seq), rec.id))
        chrom_parts.append(seq)
        chrom_len += len(seq)
        scaffolds_in_chrom += 1
    finish_chrom()
    return g.finalize()


def genome_hash(fasta_path: str, k: int, extra: str = "") -> str:
    """Content hash for index caching (the reference's summary.txt check,
    align2/RefToIndex.java:61-68)."""
    h = hashlib.sha256()
    st = os.stat(fasta_path)
    h.update(f"{os.path.abspath(fasta_path)}|{st.st_size}|{st.st_mtime_ns}|"
             f"k={k}|{extra}".encode())
    return h.hexdigest()[:16]
