"""Key counts crafted across the key retention's re-admission tiers and
its greedy trim's branches, for the retention kernel's CPU tests and
chip_smoke.py's check of the kernel on the card. numpy only."""
import numpy as np


def crafted(rng, B, nk, maxLen, off_row):
    """Counts across the re-admission tiers and the trim's branches: a few
    keys below maxLen beside keys in each band; many keys of one count
    (ties); long lists (values below the early-termination score); rows
    whose shortest list kills them; unused keys (-1)."""
    bands = [(1, 19), (20, maxLen - 1), (maxLen, (maxLen * 3) // 2 - 1),
             ((maxLen * 3) // 2, 2 * maxLen - 1),
             (2 * maxLen, 3 * maxLen - 1), (3 * maxLen, 5 * maxLen - 1),
             (5 * maxLen, 6 * maxLen)]
    kp = np.zeros((B, nk), np.int32)
    ccnt = np.zeros((B, nk), np.int32)
    for b in range(B):
        kind = b % 6
        if kind == 0:            # a few base keys and the upper bands
            band = rng.choice(len(bands), nk,
                              p=[.05, .1, .2, .2, .15, .15, .15])
        elif kind == 1:          # mostly admitted, long lists
            band = rng.choice([1, 2], nk, p=[.8, .2])
        elif kind == 2:          # ties: one count (25) repeated, its
            band = np.full(nk, -1)         # value between the early-
            #                                termination score and 0, and
            #                                a short list that keeps the
            #                                read from being killed
        elif kind == 3:          # one to three keys below maxLen:
            band = rng.choice([2, 3, 4, 5, 6], nk)      # escalation
            band[rng.choice(nk, int(rng.integers(1, 4)), replace=False)] = 1
        elif kind == 4:          # every list long: the row is killed
            band = np.full(nk, 1)
        else:                    # short lists, few keys
            band = rng.choice([0, 1], nk, p=[.7, .3])
        for j in range(nk):
            if band[j] < 0:
                ccnt[b, j] = 25 if j else 10
            else:
                lo, hi = bands[band[j]]
                ccnt[b, j] = rng.integers(lo, hi + 1)
        if kind == 4:
            ccnt[b] = np.maximum(ccnt[b], 25)
        unused = rng.random(nk) < (0.3 if kind == 5 else 0.08)
        kp[b] = np.where(unused, -1, rng.integers(0, 1 << 20, nk))
        ccnt[b] = np.where(unused, 0, ccnt[b])
        ccnt[b, rng.random(nk) < 0.03] = 0          # a key with no site
    off = np.broadcast_to(np.asarray(off_row, np.int32), (B, nk)).copy()
    return kp, off, ccnt
