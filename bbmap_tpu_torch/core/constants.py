"""Alignment scoring model of the multi-state banded affine aligner.

These constants define SAM-equivalence with the reference implementation
(reference: align2/MultiStateAligner11ts.java:2387-2427). The aligner packs
``score << TIMEBITS | streak`` into an int32 per DP cell; penalties depend on
the current run-length ("streak") of the state, giving a piecewise-affine
gap/sub model.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# --- packing (reference: align2/MultiStateAligner11ts.java:2387-2396) ---
TIMEBITS = 11
SCOREBITS = 32 - TIMEBITS
MAX_TIME = (1 << TIMEBITS) - 1
MAX_SCORE = ((1 << (SCOREBITS - 1)) - 1) - 2000
MIN_SCORE = -MAX_SCORE
SCOREOFFSET = TIMEBITS
TIMEMASK = (1 << TIMEBITS) - 1
SCOREMASK = ((1 << SCOREBITS) - 1) << SCOREOFFSET  # sign-extends in int32 use

# --- DP states ---
MODE_MS = 0
MODE_DEL = 1
MODE_INS = 2

# --- scoring table (reference: align2/MultiStateAligner11ts.java:2403-2427) ---
POINTS_NOREF = 0
POINTS_NOCALL = 0
POINTS_MATCH = 70
POINTS_MATCH2 = 100
POINTS_COMPATIBLE = 50
POINTS_SUB = -127
POINTS_SUBR = -147   # sub after a match streak of <=1
POINTS_SUB2 = -51
POINTS_SUB3 = -25
POINTS_MATCHSUB = -10
POINTS_INS = -395
POINTS_INS2 = -39
POINTS_INS3 = -23
POINTS_INS4 = -8
POINTS_DEL = -472
POINTS_DEL2 = -33
POINTS_DEL3 = -9
POINTS_DEL4 = -1
POINTS_DEL5 = -1
POINTS_DEL_REF_N = -10

TIMESLIP = 4
MASK5 = TIMESLIP - 1
BARRIER_I1 = 2
BARRIER_D1 = 3

LIMIT_FOR_COST_3 = 5
LIMIT_FOR_COST_4 = 20
LIMIT_FOR_COST_5 = 80

BAD = MIN_SCORE - 1

# --- gap compression (reference: align2/Shared.java:21-26) ---
GAPLEN = 128          # one GAPC reference symbol stands for this many bases
GAPBUFFER = 64        # ungapped buffer kept on each side of a gap
GAPBUFFER2 = 2 * GAPBUFFER
MINGAP = GAPBUFFER2 + GAPLEN
GAPCOST = max(1, GAPLEN // 64)
GAPC = ord('-')

POINTS_GAP = -GAPCOST

# "off" (pre-shifted) forms
def _off(x: int) -> int:
    return x << SCOREOFFSET


POINTSoff_NOREF = _off(POINTS_NOREF)
POINTSoff_NOCALL = _off(POINTS_NOCALL)
POINTSoff_MATCH = _off(POINTS_MATCH)
POINTSoff_MATCH2 = _off(POINTS_MATCH2)
POINTSoff_SUB = _off(POINTS_SUB)
POINTSoff_SUBR = _off(POINTS_SUBR)
POINTSoff_SUB2 = _off(POINTS_SUB2)
POINTSoff_SUB3 = _off(POINTS_SUB3)
POINTSoff_INS = _off(POINTS_INS)
POINTSoff_INS2 = _off(POINTS_INS2)
POINTSoff_INS3 = _off(POINTS_INS3)
POINTSoff_INS4 = _off(POINTS_INS4)
POINTSoff_DEL = _off(POINTS_DEL)
POINTSoff_DEL2 = _off(POINTS_DEL2)
POINTSoff_DEL3 = _off(POINTS_DEL3)
POINTSoff_DEL4 = _off(POINTS_DEL4)
POINTSoff_DEL5 = _off(POINTS_DEL5)
POINTSoff_DEL_REF_N = _off(POINTS_DEL_REF_N)
POINTSoff_GAP = _off(POINTS_GAP)
MAXoff_SCORE = _off(MAX_SCORE)
MINoff_SCORE = _off(MIN_SCORE)
BADoff = _off(BAD)

_ARRAY_LEN = 604  # covers the longest short-stack read (601 rows)


def _build_streak_arrays():
    """Streak-indexed penalty tables (reference:
    align2/MultiStateAligner11ts.java static block, POINTS_*_ARRAY*).
    index i = penalty for the i-th consecutive base of that state."""
    ins = np.zeros(_ARRAY_LEN, np.int64)
    ins_c = np.zeros(_ARRAY_LEN, np.int64)
    for i in range(1, _ARRAY_LEN):
        if i > LIMIT_FOR_COST_4:
            pts = POINTS_INS4
        elif i > LIMIT_FOR_COST_3:
            pts = POINTS_INS3
        elif i > 1:
            pts = POINTS_INS2
        else:
            pts = POINTS_INS
        ins[i] = pts
        ins_c[i] = max(MIN_SCORE, pts + ins_c[i - 1])
    sub = np.zeros(_ARRAY_LEN, np.int64)
    sub_c = np.zeros(_ARRAY_LEN, np.int64)
    for i in range(1, _ARRAY_LEN):
        if i > LIMIT_FOR_COST_3:
            pts = POINTS_SUB3
        elif i > 1:
            pts = POINTS_SUB2
        else:
            pts = POINTS_SUB
        sub[i] = pts
        sub_c[i] = max(MIN_SCORE, pts + sub_c[i - 1])
    return ins, ins_c, sub, sub_c


POINTS_INS_ARRAY, POINTS_INS_ARRAY_C, POINTS_SUB_ARRAY, POINTS_SUB_ARRAY_C = (
    _build_streak_arrays()
)
POINTSoff_INS_ARRAY = POINTS_INS_ARRAY << SCOREOFFSET
POINTSoff_SUB_ARRAY = POINTS_SUB_ARRAY << SCOREOFFSET


def del_streak_points(streak: int) -> int:
    """Penalty for extending a deletion whose current run length is `streak`
    (reference: align2/MultiStateAligner11ts.java:770-776)."""
    if streak == 0:
        return POINTS_DEL
    if streak < LIMIT_FOR_COST_3:
        return POINTS_DEL2
    if streak < LIMIT_FOR_COST_4:
        return POINTS_DEL3
    if streak < LIMIT_FOR_COST_5:
        return POINTS_DEL4
    return POINTS_DEL5 if (streak & MASK5) == 0 else 0


def max_quality(length: int) -> int:
    """Perfect-read score (reference: align2/MultiStateAligner11ts.java:2209)."""
    return POINTS_MATCH + (length - 1) * POINTS_MATCH2


def max_imperfect_score(length: int) -> int:
    """Best possible score containing at least one error
    (reference: align2/MultiStateAligner11ts.java:2214-2225)."""
    return max_quality(length) + min(POINTS_DEL, POINTS_INS - POINTS_MATCH2)


class ScoringProfile(NamedTuple):
    """One aligner scoring model. SHORT = MultiStateAligner11ts
    (reference: align2/MultiStateAligner11ts.java:2387-2436); PACBIO =
    MultiStateAligner9PacBio (reference:
    align2/MultiStateAligner9PacBio.java:2359-2408 — flatter sub/indel
    penalties, TIMEBITS=9, barriers 1/1) for ~15% error long reads.
    Hashable, so it can be a static jit argument."""
    name: str
    TIMEBITS: int
    SCOREOFFSET: int
    TIMEMASK: int
    MAX_TIME: int
    MASK5: int
    BARRIER_I1: int
    BARRIER_D1: int
    LIMIT_FOR_COST_3: int
    LIMIT_FOR_COST_4: int
    LIMIT_FOR_COST_5: int
    POINTS_MATCH: int
    POINTS_MATCH2: int
    POINTS_SUB: int
    POINTS_SUBR: int
    POINTS_SUB2: int
    POINTS_SUB3: int
    POINTS_NOCALL: int
    POINTS_INS: int
    POINTS_INS2: int
    POINTS_INS3: int
    POINTS_INS4: int
    POINTS_DEL: int
    POINTS_DEL2: int
    POINTS_DEL3: int
    POINTS_DEL4: int
    POINTS_DEL5: int
    POINTS_DEL_REF_N: int
    POINTS_GAP: int
    POINTSoff_MATCH: int
    POINTSoff_MATCH2: int
    POINTSoff_SUB: int
    POINTSoff_SUBR: int
    POINTSoff_SUB2: int
    POINTSoff_SUB3: int
    POINTSoff_NOCALL: int
    POINTSoff_INS: int
    POINTSoff_INS2: int
    POINTSoff_INS3: int
    POINTSoff_INS4: int
    POINTSoff_DEL: int
    POINTSoff_DEL2: int
    POINTSoff_DEL3: int
    POINTSoff_DEL4: int
    POINTSoff_DEL5: int
    POINTSoff_DEL_REF_N: int
    POINTSoff_GAP: int
    BADoff: int

    def max_quality(self, length: int) -> int:
        return self.POINTS_MATCH + (length - 1) * self.POINTS_MATCH2

    def max_imperfect_score(self, length: int) -> int:
        return self.max_quality(length) + min(
            self.POINTS_DEL, self.POINTS_INS - self.POINTS_MATCH2)


def _make_profile(name: str, timebits: int, barrier_i1: int,
                  barrier_d1: int, pts: dict) -> ScoringProfile:
    off = timebits
    max_score = ((1 << (32 - timebits - 1)) - 1) - 2000
    bad = -max_score - 1
    offs = {("POINTSoff_" + k[7:]): v << off for k, v in pts.items()}
    return ScoringProfile(
        name=name, TIMEBITS=timebits, SCOREOFFSET=off,
        TIMEMASK=(1 << timebits) - 1, MAX_TIME=(1 << timebits) - 1,
        MASK5=MASK5, BARRIER_I1=barrier_i1, BARRIER_D1=barrier_d1,
        LIMIT_FOR_COST_3=5, LIMIT_FOR_COST_4=20, LIMIT_FOR_COST_5=80,
        BADoff=bad << off, **pts, **offs)


SHORT_PROFILE = _make_profile(
    "short", TIMEBITS, BARRIER_I1, BARRIER_D1, dict(
        POINTS_MATCH=70, POINTS_MATCH2=100, POINTS_SUB=-127,
        POINTS_SUBR=-147, POINTS_SUB2=-51, POINTS_SUB3=-25,
        POINTS_NOCALL=0, POINTS_INS=-395, POINTS_INS2=-39,
        POINTS_INS3=-23, POINTS_INS4=-8, POINTS_DEL=-472,
        POINTS_DEL2=-33, POINTS_DEL3=-9, POINTS_DEL4=-1,
        POINTS_DEL5=-1, POINTS_DEL_REF_N=-10, POINTS_GAP=POINTS_GAP))

# reference: align2/MultiStateAligner9PacBio.java:2359-2408
PACBIO_PROFILE = _make_profile(
    "pacbio", 9, 1, 1, dict(
        POINTS_MATCH=90, POINTS_MATCH2=100, POINTS_SUB=-137,
        POINTS_SUBR=-157, POINTS_SUB2=-49, POINTS_SUB3=-25,
        POINTS_NOCALL=0, POINTS_INS=-205, POINTS_INS2=-42,
        POINTS_INS3=-23, POINTS_INS4=-8, POINTS_DEL=-292,
        POINTS_DEL2=-37, POINTS_DEL3=-17, POINTS_DEL4=-2,
        POINTS_DEL5=-1, POINTS_DEL_REF_N=-10, POINTS_GAP=POINTS_GAP))

# reference: align2/BBMapThreadPacBio.java:27-28 — the long-read DP
# envelope (ALIGN_ROWS=6020; columns follow BBIndexPacBio.ALIGN_COLUMNS)
PACBIO_ALIGN_ROWS = 6020


def min_id_to_min_ratio(minid: float) -> float:
    """Identity -> min score ratio
    (reference: align2/MultiStateAligner11ts.java:2371-2385)."""
    if minid > 1:
        minid = minid / 100
    assert 0 < minid <= 1
    matchdif = POINTS_MATCH - POINTS_MATCH2
    match = float(POINTS_MATCH2)
    sub = -POINTS_MATCH2 + 0.5 * (matchdif + POINTS_SUB) + 0.5 * POINTS_SUB2
    dele = (0.1 * (matchdif + POINTS_DEL) + 0.2 * POINTS_DEL2
            + 0.4 * POINTS_DEL3 + 0.3 * POINTS_DEL4)
    ins = (-POINTS_MATCH2 + 0.4 * (matchdif + POINTS_INS)
           + 0.3 * POINTS_INS2 + 0.3 * POINTS_INS3)
    bad_avg = 0.7 * sub + 0.2 * dele + 0.1 * ins
    bad_fraction = 1 - minid
    minratio = (match + bad_fraction * bad_avg) / match
    return float(np.float32(max(0.1, minratio)))
