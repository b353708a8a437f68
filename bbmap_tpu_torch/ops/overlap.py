"""Pair-overlap scan for BBMerge, vectorized over a batch of pairs.

Clone of the reference's mismatch-count overlap kernel (reference:
jgi/BBMergeOverlapper.mateByOverlapJava_unrolled:543-660,
jni/BBMergeOverlapper.c:439): for every candidate overlap length, count
quality-gated good/bad base agreements between read 1's suffix and the
(already reverse-complemented) read 2's prefix, then apply the
margin-based best/ambiguity ladder.

The reference's inner early-exit (stop counting past badlim) only ever
abandons overlaps that lose every later comparison, so full vectorized
counting is decision-equivalent (see the candidate ladder: a partial
count > bestBad fails ``bad<=bestBad`` exactly as the full count does).

The scan itself is one numpy pass per overlap value across all pairs;
decision state (best/ambig/done) advances with vector ops, preserving the
reference's sequential tie semantics.

The port's copy of the JAX package's module: both ladders' entry points
take a device and run the torch programs of ``overlap_device`` there;
the numpy ladders stay as their plain reference (``*_plain``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

PROB_CORRECT = 1.0 - 10.0 ** (-np.arange(128) / 10.0)

RET_AMBIG = -1
RET_NO_SOLUTION = -2


def mate_by_overlap_batch(
        a_bases: np.ndarray, a_qual: Optional[np.ndarray],
        b_bases: np.ndarray, b_qual: Optional[np.ndarray],
        min_overlap0: int = 8, min_overlap: int = 11,
        min_insert0: int = 35, margin: int = 2,
        max_mismatches0: int = 3, max_mismatches: int = 3,
        minq: int = 10, *, device
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """a_bases (B, alen), b_bases (B, blen) uint8 ASCII (b already rc'd to
    read-1 orientation); quals phred or None.

    Returns (insert (B,) int32 with -1 for no-merge, bad (B,) int32,
    ambig (B,) bool), computed on ``device``."""
    from . import overlap_device as od
    return od.mate_by_overlap_device(
        a_bases, a_qual, b_bases, b_qual, min_overlap0, min_overlap,
        min_insert0, margin, max_mismatches0, max_mismatches, minq,
        device=device)


def mate_by_overlap_batch_plain(
        a_bases: np.ndarray, a_qual: Optional[np.ndarray],
        b_bases: np.ndarray, b_qual: Optional[np.ndarray],
        min_overlap0: int = 8, min_overlap: int = 11,
        min_insert0: int = 35, margin: int = 2,
        max_mismatches0: int = 3, max_mismatches: int = 3,
        minq: int = 10) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """numpy reference of ``mate_by_overlap_batch``."""
    B, alen = a_bases.shape
    blen = b_bases.shape[1]
    min_overlap0 = min(max(1, min_overlap0), min_overlap)
    margin = max(margin, 0)

    if a_qual is not None and b_qual is not None:
        aprob = PROB_CORRECT[np.clip(a_qual, 0, 127)]
        bprob = PROB_CORRECT[np.clip(b_qual, 0, 127)]
    else:
        aprob = np.full((B, alen), 0.98)
        bprob = np.full((B, blen), 0.98)
    minprob = PROB_CORRECT[min(max(1, minq), 41)]

    best_overlap = np.full(B, -1, np.int32)
    best_good = np.full(B, -1, np.int32)
    best_bad = np.full(B, max_mismatches0, np.int32)
    ambig = np.zeros(B, bool)
    done = np.zeros(B, bool)
    early_ret = np.zeros(B, bool)

    max_overlap = alen + blen - max(min_overlap, min_insert0)
    for overlap in range(max(min_overlap0, 0), max_overlap):
        istart = 0 if overlap <= alen else overlap - alen
        jstart = alen - overlap if overlap <= alen else 0
        iters = min(overlap - istart, blen - istart, alen - jstart)
        if iters <= 0:
            continue
        aj = a_bases[:, jstart:jstart + iters]
        bi = b_bases[:, istart:istart + iters]
        pc = aprob[:, jstart:jstart + iters] * bprob[:, istart:istart + iters]
        counted = pc > minprob
        eq = aj == bi
        good = (counted & eq).sum(1).astype(np.int32)
        bad = (counted & ~eq).sum(1).astype(np.int32)

        # decision ladder (reference: :612-646)
        active = ~done
        cand = active & (bad * 2 < good)
        c1 = cand & (good > min_overlap) & (bad <= best_bad)
        winner = c1 & ((bad < best_bad) | ((bad == best_bad)
                                           & (good > best_good)))
        ambig |= winner & (best_bad - bad < margin)
        tie = c1 & ~winner & (bad == best_bad)
        ambig |= tie
        best_overlap = np.where(winner, overlap, best_overlap)
        best_good = np.where(winner, good, best_good)
        best_bad = np.where(winner, bad, best_bad)
        # early return 'f': ambig with bestBad<margin -> result -1
        f = c1 & ambig & (best_bad < margin)
        early_ret |= f
        done |= f
        # branch 'g': weak candidate with few mismatches -> ambiguous
        g = cand & ~(good > min_overlap) & (bad < margin)
        ambig |= g
        early_ret |= g
        done |= g
        if done.all():
            break

    no_sln = (~ambig) & (best_bad > max_mismatches - margin)
    best_overlap = np.where(no_sln | early_ret, -1, best_overlap)
    insert = np.where(best_overlap < 0, -1, alen + blen - best_overlap)
    return insert.astype(np.int32), best_bad, ambig


def join_pairs(a_bases, a_qual, b_bases, b_qual, inserts,
               max_merge_quality: int = 41):
    """Consensus-join each overlapping pair at its insert size
    (reference: stream/Read.joinRead:2744-2850): agreeing bases take
    min(max(q)+min(q)/4, cap); disagreeing take the higher-quality base
    (N on tie) with quality max-min. b is in read-1 orientation.
    Returns list of (bases bytes, qual bytes|None) for inserts>0."""
    out = []
    B, alen = a_bases.shape
    blen = b_bases.shape[1]
    for i in range(B):
        insert = int(inserts[i])
        if insert <= 0:
            out.append(None)
            continue
        bases = np.full(insert, ord("N"), np.uint8)
        n = min(alen, insert)
        bases[:n] = a_bases[i, :n]
        if a_qual is not None:
            quals = np.zeros(insert, np.int16)
            quals[:n] = a_qual[i, :n]
        else:
            quals = None
        # walk b from its end aligned to the join's end
        ii = insert - 1
        j = blen - 1
        while ii >= 0 and j >= 0:
            ca, cb = bases[ii], b_bases[i, j]
            if quals is None:
                if ca == 0 or ca == ord("N"):
                    bases[ii] = cb
                elif ca != cb and cb != ord("N"):
                    bases[ii] = max(ca, cb)
            else:
                qa, qb = int(quals[ii]), int(b_qual[i, j])
                if ca == 0 or ca == ord("N"):
                    bases[ii] = cb
                    quals[ii] = qb
                elif cb == 0 or cb == ord("N"):
                    pass
                elif ca == cb:
                    quals[ii] = min(max(qa, qb) + min(qa, qb) // 4,
                                    max_merge_quality)
                else:
                    bases[ii] = ca if qa > qb else (cb if qa < qb
                                                    else ord("N"))
                    quals[ii] = max(qa, qb) - min(qa, qb)
            ii -= 1
            j -= 1
        q = None
        if quals is not None:
            q = bytes(np.clip(quals, 0, 127).astype(np.uint8) + 33)
        out.append((bytes(bases), q))
    return out


# ---------------------------------------------------------------------------
# Ratio mode — the reference's DEFAULT overlap scorer
# (reference: jgi/BBMergeOverlapper.mateByOverlapRatioJava:280-436,
# jgi/BBMerge.java:2339 useRatioMode=true). Inserts are scanned from
# largest to smallest; candidate quality is the mismatch ratio
# (bad+offset)/overlapLength with margin-based best/second tracking.
# Decision state advances with vector ops across the pair batch.
# ---------------------------------------------------------------------------

def mate_by_overlap_ratio_batch(
        a_bases: np.ndarray, b_bases: np.ndarray,
        min_overlap0: int = 5, min_overlap: int = 8,
        min_insert0: int = 26, min_insert: int = 35,
        max_ratio: float = 0.09, min_second_ratio: float = 0.1,
        margin: float = 5.5, offset: float = 0.55,
        g_incr: float = 0.95, b_incr: float = 0.95, *, device
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """b_bases already rc'd to read-1 orientation.
    Returns (insert (B,), bad (B,) float->int, ambig (B,)), computed on
    ``device``."""
    from . import overlap_device as od
    return od.mate_by_overlap_ratio_device(
        a_bases, b_bases, min_overlap0, min_overlap, min_insert0,
        min_insert, max_ratio, min_second_ratio, margin, offset, g_incr,
        b_incr, device=device)


def mate_by_overlap_ratio_batch_plain(
        a_bases: np.ndarray, b_bases: np.ndarray,
        min_overlap0: int = 5, min_overlap: int = 8,
        min_insert0: int = 26, min_insert: int = 35,
        max_ratio: float = 0.09, min_second_ratio: float = 0.1,
        margin: float = 5.5, offset: float = 0.55,
        g_incr: float = 0.95, b_incr: float = 0.95
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """numpy reference of ``mate_by_overlap_ratio_batch``."""
    B, alen = a_bases.shape
    blen = b_bases.shape[1]
    min_overlap = max(4, min_overlap0, min_overlap)
    min_overlap0 = int(np.clip(min_overlap0, 4, min_overlap))
    min_length = min(alen, blen)
    margin2 = (margin + offset) / min_length
    _Nc = ord("N")

    largest = alen + blen - min_overlap0
    smallest = min_insert0

    # precompute good/bad/olen per insert (full counting is
    # decision-equivalent to the reference's early-exit, see the
    # mismatch-mode proof above)
    inserts = list(range(largest, smallest - 1, -1))
    n_ins = len(inserts)
    goods = np.zeros((n_ins, B), np.float32)
    bads = np.zeros((n_ins, B), np.float32)
    olens = np.zeros(n_ins, np.int32)
    for t, insert in enumerate(inserts):
        istart = 0 if insert <= blen else insert - blen
        jstart = 0 if insert >= blen else blen - insert
        olen = min(alen - istart, blen - jstart, insert)
        if olen <= 0:
            continue
        olens[t] = olen
        ai = a_bases[:, istart:istart + olen]
        bj = b_bases[:, jstart:jstart + olen]
        eq = ai == bj
        nn = ai != _Nc
        goods[t] = (eq & nn).sum(1) * g_incr
        bads[t] = (~eq).sum(1) * b_incr

    # findBestRatio pre-pass tightens maxRatio per pair
    # (reference: findBestRatio — min achievable ratio)
    valid_t = olens > 0
    off32 = np.float32(offset)
    with np.errstate(divide="ignore", invalid="ignore"):
        # float32 throughout — the reference computes ratios in Java
        # floats, and mixing precisions here breaks the x == bestRatio
        # boundary case
        all_ratio = np.where(
            valid_t[:, None],
            (bads + off32) / np.maximum(olens[:, None], 1)
            .astype(np.float32), np.float32(np.inf)).astype(np.float32)
    # findBestRatio scans inserts in [min_insert, alen+blen-min_overlap]
    fb_mask = np.array([min_insert <= ins <= alen + blen - min_overlap
                        for ins in inserts])
    x = np.min(np.where(fb_mask[:, None], all_ratio, np.inf), axis=0)
    x = np.minimum(x, np.float32(max_ratio + 0.0001))
    no_solution = x > np.float32(max_ratio)
    max_ratio_v = np.minimum(np.float32(max_ratio), x).astype(np.float32)

    best_insert = np.full(B, -1, np.int32)
    best_bad = np.full(B, float(min_length), np.float32)
    best_ratio = np.ones(B, np.float32)
    second_ratio = np.ones(B, np.float32)
    ambig = np.zeros(B, bool)
    done = no_solution.copy()
    early_neg = no_solution.copy()
    extra_mult = 1.2

    for t, insert in enumerate(inserts):
        if not valid_t[t]:
            continue
        olen = float(olens[t])
        good = goods[t]
        bad = bads[t]
        badlimit = extra_mult * (np.minimum(best_ratio, max_ratio_v)
                                 * margin * olen) + 1.0
        active = ~done
        cond0 = active & (bad <= badlimit)
        e1 = cond0 & (bad == 0) & (good > min_overlap0) \
            & (good < min_overlap)
        ambig = np.where(e1, True, ambig)
        early_neg |= e1
        done |= e1
        ratio = ((bad + off32) / np.float32(olen)).astype(np.float32)
        c2 = cond0 & ~e1 & (ratio < best_ratio * np.float32(margin))
        new_ambig = (ratio * margin >= best_ratio) | (good < min_overlap)
        ambig = np.where(c2, new_ambig, ambig)
        improve = c2 & (ratio < best_ratio)
        # shift best -> second on improvement
        second_ratio = np.where(improve, best_ratio,
                                second_ratio).astype(np.float32)
        best_insert = np.where(improve, insert, best_insert)
        best_bad = np.where(improve, bad, best_bad)
        best_ratio = np.where(improve, ratio,
                              best_ratio).astype(np.float32)
        tie2 = c2 & ~improve & (ratio < second_ratio)
        second_ratio = np.where(tie2, ratio,
                                second_ratio).astype(np.float32)
        f = c2 & ((ambig & (best_ratio < margin2))
                  | (second_ratio < min_second_ratio))
        early_neg |= f
        done |= f
        if done.all():
            break

    final_neg = early_neg | ((~ambig) & (best_ratio > max_ratio_v))
    insert_out = np.where(final_neg, -1, best_insert)
    return (insert_out.astype(np.int32),
            best_bad.astype(np.int32), ambig)


def calc_min_overlap_by_entropy(bases: np.ndarray, k: int = 3,
                                min_score: int = 39,
                                tail: bool = True) -> int:
    """Per-read minimum overlap from sequence complexity
    (reference: jgi/BBMergeOverlapper.calcMinOverlapByEntropyTail/Head:
    860-935): walking inward from the overlap end, accumulate
    ones*4 + twos over the k-mer spectrum; the overlap must be long
    enough to reach min_score. Low-complexity tails demand longer
    overlaps."""
    from ..core.bases import BASE_TO_NUMBER
    mask = (1 << (2 * k)) - 1
    counts = np.zeros(1 << (2 * k), np.int16)
    kmer = 0
    length = 0
    ones = twos = 0
    n = len(bases)
    order = range(n - 1, -1, -1) if tail else range(n)
    for t, j in enumerate(order):
        b = BASE_TO_NUMBER[bases[j]]
        if b < 0:
            length = 0
            kmer = 0
            continue
        length += 1
        kmer = ((kmer << 2) | int(b)) & mask
        if length >= k:
            counts[kmer] += 1
            if counts[kmer] == 1:
                ones += 1
            elif counts[kmer] == 2:
                twos += 1
            if ones * 4 + twos >= min_score:
                return t
    return n + 1
