"""Base-code tables (reference: dna/AminoAcid.java).

2-bit codes: A=0, C=1, G=2, T=3 (U=3). Everything else (N, IUPAC degenerate
codes) is undefined for k-mer purposes. Host-side tables are numpy; device
code uses the uint8 code arrays produced here.
"""

from __future__ import annotations

import numpy as np

N_CODE = 4  # sentinel for undefined bases in code arrays

BASE_TO_NUMBER = np.full(256, -1, np.int8)
for i, ch in enumerate("ACGT"):
    BASE_TO_NUMBER[ord(ch)] = i
    BASE_TO_NUMBER[ord(ch.lower())] = i
BASE_TO_NUMBER[ord("U")] = 3
BASE_TO_NUMBER[ord("u")] = 3

NUMBER_TO_BASE = np.frombuffer(b"ACGT", np.uint8).copy()

# IUPAC-extended definedness (reference: AminoAcid.baseToNumberExtended —
# letters with any base meaning stay as letters; others become N)
_IUPAC = "ACGTUMRWSYKVHDBNX"
IS_IUPAC = np.zeros(256, bool)
for ch in _IUPAC:
    IS_IUPAC[ord(ch)] = True
    IS_IUPAC[ord(ch.lower())] = True

_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a"):ord("z") + 1] -= 32

# complement of ASCII bases (reference: AminoAcid.baseToComplementExtended,
# restricted to ACGTN which is all the packer emits)
COMP_ASCII = np.arange(256, dtype=np.uint8)
for a, b in [("A", "T"), ("C", "G"), ("G", "C"), ("T", "A"),
             ("a", "t"), ("c", "g"), ("g", "c"), ("t", "a")]:
    COMP_ASCII[ord(a)] = ord(b)


def clean_ascii(seq: np.ndarray) -> np.ndarray:
    """Uppercase; non-IUPAC characters -> 'N'
    (reference: dna/ChromosomeArray.java:118-123)."""
    up = _UPPER[seq]
    return np.where(IS_IUPAC[up], up, np.uint8(ord("N")))


def to_codes(seq_ascii: np.ndarray) -> np.ndarray:
    """ASCII bases -> uint8 codes 0..3, undefined -> N_CODE."""
    n = BASE_TO_NUMBER[seq_ascii]
    return np.where(n < 0, np.uint8(N_CODE), n.astype(np.uint8))


def codes_to_ascii(codes: np.ndarray) -> np.ndarray:
    table = np.frombuffer(b"ACGTN", np.uint8)
    return table[np.minimum(codes, N_CODE)]


def reverse_complement_ascii(seq: np.ndarray) -> np.ndarray:
    return COMP_ASCII[seq][::-1]


def reverse_complement_codes(codes: np.ndarray) -> np.ndarray:
    """rc in code space: 3-code for defined, N_CODE stays."""
    out = np.where(codes <= 3, 3 - codes, codes)
    return out[::-1]
