"""Banded edit-distance aligner.

reference: align2/BandedAligner.java:10 / BandedAlignerConcrete.java /
jni/BandedAlignerJNI.c — maxEdits-bounded banded Levenshtein used by
Dedupe overlap verification. Implemented as a numpy band sweep (the band
is the vector lane); the port's copy of the JAX package's module, the
scalar reference of ``ops/banded_device.py`` and its CUDA kernel
(``csrc/banded_edit.cu``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def banded_edit_distance(a: np.ndarray, b: np.ndarray,
                         max_edits: int) -> int:
    """Edit distance between byte arrays a and b, banded at max_edits;
    returns a value > max_edits when the distance exceeds the band."""
    la, lb = len(a), len(b)
    if abs(la - lb) > max_edits:
        return max_edits + 1
    w = 2 * max_edits + 1
    BIG = max_edits + 1
    # band[d] = edit distance ending at column j = i + (d - max_edits)
    prev = np.full(w, BIG, np.int32)
    # row 0: distance = j
    for d in range(w):
        j = d - max_edits
        if 0 <= j <= lb:
            prev[d] = j
    for i in range(1, la + 1):
        cur = np.full(w, BIG, np.int32)
        jlo = max(1, i - max_edits)
        jhi = min(lb, i + max_edits)
        if jlo > jhi:
            return max_edits + 1
        js = np.arange(jlo, jhi + 1)
        ds = js - i + max_edits
        sub = prev[ds] + (a[i - 1] != b[js - 1])
        # deletion in a (move down): prev row same column j -> d+1 shift
        up = np.full(len(js), BIG, np.int32)
        ok = ds + 1 < w
        up[ok] = prev[ds[ok] + 1] + 1
        cur[ds] = np.minimum(sub, up)
        # insertion (move right within row) — prefix min along the band
        left = BIG
        for t, d in enumerate(ds):
            left = min(cur[d], left + 1)
            cur[d] = left
        prev = cur
        if prev.min() > max_edits:
            return max_edits + 1
    d_final = lb - la + max_edits
    if 0 <= d_final < w:
        return int(prev[d_final])
    return max_edits + 1


def align_forward(a: np.ndarray, b: np.ndarray, max_edits: int) -> int:
    """reference: BandedAligner.alignForward — edit-bounded comparison of
    a against b from the start."""
    return banded_edit_distance(a, b, max_edits)


def align_reverse(a: np.ndarray, b: np.ndarray, max_edits: int) -> int:
    return banded_edit_distance(a[::-1], b[::-1], max_edits)


def align_forward_rc(a: np.ndarray, b: np.ndarray, max_edits: int) -> int:
    from ..core.bases import COMP_ASCII
    return banded_edit_distance(a, COMP_ASCII[b][::-1], max_edits)
