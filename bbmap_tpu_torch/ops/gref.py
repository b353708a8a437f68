"""Gap-compressed reference windows for long-indel alignment.

reference: align2/MultiStateAligner10ts.makeGref:2307-2400 +
align2/Shared.java:21-26 (GAPLEN/GAPBUFFER/MINGAP/GAPC). Deletions up to
maxindel (16 kbp default, 100 kbp+ in principle) do not widen the DP
matrix: the interior of each gap is replaced by GAPC symbols worth
GAPLEN=128 reference bases each, keeping the DP near-diagonal. The DP
kernels already understand GAPC (subfloor match plane, POINTS_GAP
deletion extension, '-' traceback symbols expanded to 128 D's), so the
only new pieces are window construction and coordinate translation.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.constants import GAPBUFFER, GAPBUFFER2, GAPC, GAPLEN, MINGAP


def make_gref(genome: np.ndarray, segments: List[Tuple[int, int]]
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Build a gap-compressed window from real-ref segments.

    segments: inclusive (start, stop) flat-genome pairs, ascending,
    separated by gaps >= MINGAP. Returns (gref ASCII uint8,
    col_to_ref int64: gref column -> flat ref position of that column's
    FIRST represented base)."""
    segments = [(int(a), int(b)) for a, b in segments]
    G = len(genome)
    parts: List[np.ndarray] = []
    colmap: List[np.ndarray] = []

    def real(a: int, b: int) -> None:
        a = max(0, min(a, G - 1))
        b = max(0, min(b, G - 1))
        if b < a:
            return
        parts.append(genome[a:b + 1])
        colmap.append(np.arange(a, b + 1, dtype=np.int64))

    i = 0
    while i < len(segments):
        x, y = segments[i]
        if i + 1 < len(segments):
            z = segments[i + 1][0]
            gap = z - y - 1
            assert gap >= MINGAP, (gap, MINGAP)
            rem = gap % GAPLEN
            div = (gap - GAPBUFFER2) // GAPLEN
            # reference layout (:2368-2390): segment + GAPBUFFER + rem
            # real bases, div GAPC symbols, GAPBUFFER real bases glued to
            # the next segment
            real(x, y + GAPBUFFER + rem)
            gstart = y + GAPBUFFER + rem + 1
            parts.append(np.full(div, GAPC, np.uint8))
            colmap.append(gstart + np.arange(div, dtype=np.int64) * GAPLEN)
            segments[i + 1] = (z - GAPBUFFER, segments[i + 1][1])
        else:
            real(x, y)
        i += 1
    gref = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    c2r = np.concatenate(colmap) if colmap else np.zeros(0, np.int64)
    assert len(gref) == len(c2r), (len(gref), len(c2r))
    return gref, c2r


def chain_segments(diags: np.ndarray, read_len: int,
                   pad: int = 8) -> List[Tuple[int, int]]:
    """Cluster chain diagonals into real-ref segments separated by
    >= MINGAP; each cluster covers [min_diag - pad,
    max_diag + read_len + pad]."""
    diags = np.sort(np.asarray(diags, np.int64))
    clusters = []
    start = prev = int(diags[0])
    for d in diags[1:]:
        d = int(d)
        if d - prev > MINGAP:
            clusters.append((start, prev))
            start = d
        prev = d
    clusters.append((start, prev))
    segs = [(a - pad, b + read_len - 1 + pad) for a, b in clusters]
    merged = [segs[0]]
    for a, b in segs[1:]:
        pa, pb = merged[-1]
        if a - pb - 1 < MINGAP:
            merged[-1] = (pa, max(pb, b))
        else:
            merged.append((a, b))
    return merged
