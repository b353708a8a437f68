"""Reference-faithful key-retention oracle: the exact staged
re-admission + Solver-weighted greedy hit-list trimming of
BBIndex.find (reference: align2/BBIndex.java:403-505,
trimExcessHitListsByGreedy:266-352, Solver.java:24-151).

This is the host-side truth the device admission is validated against
(tests/test_search_oracle.py). All quirks of the Java are preserved
deliberately:

- ``count()`` consults the CANONICAL (key + rc summed) COUNTS table
  (reference: AbstractIndex.count:28-35, analyzeIndex:147-151), not the
  per-strand list length.
- re-admission thresholds use integer arithmetic ((maxLen*3)/2 etc.)
  and STRICT ``len < maxLen`` (reference: countHits:376-390).
- the greedy loop's early-exit scans ascending with the
  EARLY_TERMINATION_SCORE quirk: the threshold is frozen at the Solver
  class-load value -50*2000 = -100000 (the reference never updates it
  when POINTS_PER_SITE is re-derived — Solver.java:232 "TODO: Should be
  set dynamically"), and the weight lookup indexes by LIST position,
  not key slot (Solver callers pass weights[i] for lists[i] —
  BBIndex.java:305 via findWorstGreedy's loop variable).
- ``valuep * keyWeight`` multiplies a long by a float — float32
  arithmetic, truncated toward zero (Java semantics).
- trimming decides on the PLUS-strand key set once per read; the minus
  strand mirrors it (find() trims keysP before deriving keysM,
  BBIndex.java:457-524), which is self-consistent because canonical
  counts are strand-symmetric.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

KEYLEN_DEFAULT = 13
SMALL_GENOME_LIST = 20
MIN_HIT_LISTS_TO_RETAIN = 6          # reference: BBIndex.java:3232
HIT_FRACTION_TO_RETAIN = 0.85        # reference: BBIndex.java:3226
POINTS_PER_LIST = 30000
POINTS_PER_BASE1 = 6000
BONUS_POINTS_FOR_END_LIST = 40000
POINTS_FOR_TOTAL_LIST_WIDTH = 5500
MULT_FOR_SPACING_PENALTY = -30
EARLY_TERMINATION_SCORE = -50 * 2000  # frozen at class-load (see above)
BASE_KEY_HIT_SCORE_PER_K = 100       # BASE_HIT_SCORE; a = 100*k


def count_hits(keys: np.ndarray, counts: np.ndarray, max_len: int,
               clear: bool = True) -> Tuple[int, np.ndarray]:
    """countHits (reference: BBIndex.java:376-390): a key is a hit iff
    0 < count < max_len; cleared keys become -1."""
    out = keys.copy()
    num = 0
    for i, key in enumerate(out):
        if key >= 0:
            ln = int(counts[key])
            if 0 < ln < max_len:
                num += 1
            elif clear:
                out[i] = -1
    return num, out


def staged_readmission(keys_original: np.ndarray, counts: np.ndarray,
                       max_len: int) -> Tuple[int, np.ndarray]:
    """find:421-440: progressively longer lists re-admitted when too few
    keys hit at the base threshold (each stage restarts from the
    original keys)."""
    num, keys = count_hits(keys_original, counts, max_len)
    if num > 0:
        trigger = (3 * len(keys_original)) // 4
        if num < 4 and num < trigger:
            num, keys = count_hits(keys_original, counts,
                                   (max_len * 3) // 2)
        if num < 3 and num < trigger:
            num, keys = count_hits(keys_original, counts, max_len * 2)
        if num < 3 and num < trigger:
            num, keys = count_hits(keys_original, counts, max_len * 3)
        if num < 2 and num < trigger:
            num, keys = count_hits(keys_original, counts, max_len * 5)
    return num, keys


def value_of_element(offsets: np.ndarray, lengths: np.ndarray,
                     key_weight: float, chunk: int, lists, index: int,
                     points_per_site: int) -> int:
    """Solver.valueOfElement (reference: Solver.java:74-151)."""
    numlists = len(lists)
    if numlists < 1:
        return 0
    prospect = lists[index]
    if lengths[prospect] == 0:
        return -999999
    valuep = (POINTS_PER_LIST + (POINTS_PER_LIST * 2 // numlists)
              + (POINTS_PER_LIST * 10 // int(lengths[prospect])))
    valuem = points_per_site * int(lengths[prospect])
    if prospect == 0 or prospect == len(offsets) - 1:
        valuep += BONUS_POINTS_FOR_END_LIST
    if numlists == 1:
        valuep += (POINTS_FOR_TOTAL_LIST_WIDTH + POINTS_PER_BASE1) \
            * chunk
        return int(np.float32(valuep) * np.float32(key_weight)) + valuem

    first = lists[0]
    last = lists[numlists - 1]
    offL = -1 if prospect == first else int(offsets[lists[index - 1]])
    offP = int(offsets[prospect])
    offR = (int(offsets[-1]) + 1) if prospect == last \
        else int(offsets[lists[index + 1]])
    old_left = offP - offL
    old_right = offR - offP
    new_space = offR - offL
    space_score = ((old_left * old_left + old_right * old_right)
                   - new_space * new_space) * MULT_FOR_SPACING_PENALTY
    valuep += space_score
    if prospect == first:
        uniquely = offR - offP
    elif prospect == last:
        uniquely = offP - offL
    else:
        b = offR - (offL + chunk)
        uniquely = b if b > 0 else 0
    if prospect == first or prospect == last:
        valuep += (POINTS_PER_BASE1 + POINTS_FOR_TOTAL_LIST_WIDTH) \
            * uniquely
    else:
        valuep += POINTS_PER_BASE1 * uniquely
    return int(np.float32(valuep) * np.float32(key_weight)) + valuem


def find_worst_greedy(offsets, lengths, weights, chunk: int, lists,
                      points_per_site: int) -> Tuple[int, int]:
    """Solver.findWorstGreedy weighted (reference: Solver.java:47-71):
    ascending scan, min tracking, early return at index i when the
    PREVIOUS min is already below EARLY_TERMINATION_SCORE and i != 0."""
    min_v = np.iinfo(np.int64).max
    worst = -1
    for i in range(len(lists)):
        # weight indexed by list POSITION (reference quirk, see module
        # docstring)
        v = value_of_element(offsets, lengths, float(weights[i]), chunk,
                             lists, i, points_per_site)
        if v < min_v:
            if min_v < EARLY_TERMINATION_SCORE and i != 0:
                return i, int(np.clip(v, -2 ** 31, 2 ** 31 - 1))
            min_v = v
            worst = i
    return worst, int(np.clip(min_v, -2 ** 31, 2 ** 31 - 1))


def trim_greedy(offsets: np.ndarray, key_scores: np.ndarray,
                max_lists: int, keys: np.ndarray, counts: np.ndarray,
                k: int, limit_avg: int, limit_avg2: int,
                limit_shortest: int, points_per_site: int,
                min_hits: int = 1, slow: bool = False
                ) -> Tuple[int, np.ndarray]:
    """trimExcessHitListsByGreedy (reference: BBIndex.java:266-352).
    Arrays are the SHRUNK (post-readmission, compacted) views; returns
    (hitsCount, keys-with-removed=-1)."""
    keys = keys.copy()
    nk = len(keys)
    a = BASE_KEY_HIT_SCORE_PER_K * k
    inv = np.float32(1.0) / np.float32(a)
    weights = (key_scores.astype(np.float32) * inv)
    limit = max(SMALL_GENOME_LIST, limit_avg) * nk
    limit2 = max(SMALL_GENOME_LIST, limit_avg2)
    limit3 = max(SMALL_GENOME_LIST, limit_shortest)

    lengths = np.zeros(nk, np.int64)
    total = 0
    initial = 0
    shortest = np.iinfo(np.int64).max - 1
    shortest2 = np.iinfo(np.int64).max
    for i, key in enumerate(keys):
        x = int(counts[key]) if key >= 0 else 0
        lengths[i] = x
        total += x
        if x > 0:
            initial += 1
            if x < shortest2:
                shortest2 = x
                if shortest2 < shortest:
                    shortest2 = shortest
                    shortest = x
    if initial < min_hits:
        return initial, keys
    if shortest > limit3 and not slow:
        keys[:] = -1
        return 0, keys

    hits_count = initial
    while hits_count >= min_hits and (
            total > limit or total // initial > limit2
            or hits_count > max_lists):
        lists = [i for i in range(nk) if lengths[i] > 0]
        worst_index, worst_value = find_worst_greedy(
            offsets, lengths, weights, k, lists, points_per_site)
        worst = lists[worst_index]
        total -= int(lengths[worst])
        if worst_value > 0 or lengths[worst] < SMALL_GENOME_LIST:
            return hits_count, keys
        hits_count -= 1
        lengths[worst] = 0
        keys[worst] = -1
    return hits_count, keys


def key_scores_from_quality(quality: np.ndarray, offsets: np.ndarray,
                            k: int) -> Tuple[np.ndarray, float]:
    """keyProbs-derived Solver key scores + the probAllErrors product
    for one read (reference: AbstractMapThread.java:704-727 —
    keyScoresAll[i] = baseKeyScore + (int)Math.round(range*(1-probs[i]))
    with a = BASE_KEY_HIT_SCORE = 100*k, baseKeyScore = a/8,
    range = a - baseKeyScore; probAllErrors = prod(keyProbs[offsets]),
    read rejected when > 0.5). All float32 like the Java. Returns
    (key_scores int32 aligned with ``offsets``, prob_all_errors)."""
    from . import seed as seed_host
    probs = seed_host.make_key_probs(quality, k)          # float32
    a = BASE_KEY_HIT_SCORE_PER_K * k
    base = a // 8
    rng = a - base
    p = probs[np.asarray(offsets, np.int64)].astype(np.float32)
    scores = base + np.floor(
        np.float32(rng) * (np.float32(1.0) - p)
        + np.float32(0.5)).astype(np.int64)
    pae = np.float32(1.0)
    for v in p:
        pae = np.float32(pae * v)
    return scores.astype(np.int32), float(pae)


def retain_keys(keys_original: np.ndarray, offsets: np.ndarray,
                key_scores: np.ndarray, index, min_hits: int = 1
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The full find() key-retention pipeline for one read's plus-strand
    keys (staged re-admission + shrink + weighted greedy trim;
    TRIM_LONG_HIT_LISTS is false by default in the reference and
    omitted). Returns (keys, offsets, key_scores) of the RETAINED lists
    (compacted; the minus strand mirrors them via rc)."""
    counts = index.counts_canonical
    assert counts is not None, "run analyze_index first"
    num, keys = staged_readmission(keys_original, counts,
                                   index.max_usable_length)
    sel = keys >= 0
    keysP = keys[sel]
    offsetsP = offsets[sel]
    scoresP = key_scores[sel]
    if num < min_hits:
        return (np.zeros(0, keysP.dtype), np.zeros(0, offsetsP.dtype),
                np.zeros(0, scoresP.dtype))
    max_lists = max(int(HIT_FRACTION_TO_RETAIN * len(keysP)),
                    MIN_HIT_LISTS_TO_RETAIN)
    _num2, keysP = trim_greedy(
        offsetsP, scoresP, max_lists, keysP, counts, index.k,
        index.limit_avg, index.limit_avg2, index.limit_shortest,
        index.points_per_site, min_hits=min_hits)
    sel2 = keysP >= 0
    return keysP[sel2], offsetsP[sel2], scoresP[sel2]
