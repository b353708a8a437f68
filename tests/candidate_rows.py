"""Rows crafted for the candidate stage's two kernels (the slot pack and
the chain step), for their CPU tests and chip_smoke.py's check of the
kernels on the card. numpy only.

``slot_rows`` gives the slot pack's per-key inputs: ties in the budget's
lengths, zero lengths, lists longer than the budget, sums landing exactly
on it, local lengths apart from the global ones, rows with nothing
admitted, first sites near the end of the sites; ``wrap_slot_rows`` adds
lengths whose int32 prefix sums wrap. ``chain_rows`` gives the
chain step's unsorted slots: all-invalid rows, steps exactly at and one
past ``chain_dist``, negative diagonals, a key slot repeated within a
chain, modal-run ties, runs longer than 255 slots and runs that start past
offset 255 of their chain (at W = 512), reads with fewer than 8 chains,
and the same chains on both strands (vote ties across strands);
``wide_chain_rows`` gives reads whose diagonals span more than the chain
kernel's 32-bit sort key holds and reads at that key's limit, and
``int32_key_fits`` says which reads the key holds."""
import numpy as np

INVALID = 2 ** 30


def slot_rows(rng, B: int, nk: int, W: int, n_sites: int):
    """gadm, cnt_local, s0, offadj (B, 2, nk) int32 and admit (B, 2, nk)
    bool, a kind of row for each (read, strand) in turn."""
    shape = (B, 2, nk)
    gadm = np.zeros(shape, np.int64)
    cnt = np.zeros(shape, np.int64)
    admit = rng.random(shape) < 0.8
    for b in range(B):
        for h in range(2):
            kind = (2 * b + h) % 8
            if kind == 0:            # short lists, some zero
                g = rng.integers(0, max(2, W // 4), nk)
            elif kind == 1:          # ties: one length everywhere
                g = np.full(nk, max(1, W // 7))
            elif kind == 2:          # zero lengths among ties and longs
                g = rng.choice([0, 0, 3, 3, W, 2 * W], nk)
            elif kind == 3:          # sums landing exactly on W
                g = np.zeros(nk, np.int64)
                parts = rng.integers(1, 4)
                at = rng.choice(nk, min(nk, parts + 1), replace=False)
                cuts = np.sort(rng.choice(np.arange(1, W), parts,
                                          replace=False))
                g[at[:parts + 1]] = np.diff(np.r_[0, cuts, W])[:len(at)]
            elif kind == 4:          # lists longer than the budget
                g = rng.integers(W + 1, 4 * W, nk)
                g[rng.integers(0, nk)] = W
            elif kind == 5:          # nothing admitted
                g = rng.integers(0, W, nk)
                admit[b, h] = False
            elif kind == 6:          # every key one slot
                g = np.ones(nk, np.int64)
            else:                    # many small ties and one whole-budget
                g = rng.choice([1, 2, 2, 5], nk)
                g[rng.integers(0, nk)] = W
            gadm[b, h] = g
            # the local length: the global one, or below it (a shard's
            # share), or past it on a few rows (totals past W)
            loc = g.copy()
            if kind in (0, 2):
                loc = (g * rng.random(nk)).astype(np.int64)
            if kind == 7:
                loc = g + rng.integers(0, 3, nk)
            cnt[b, h] = loc
    s0 = rng.integers(0, n_sites, shape)
    s0[:, :, ::5] = n_sites - rng.integers(1, 4, s0[:, :, ::5].shape)
    offadj = rng.integers(-200, 200, shape)
    return (gadm.astype(np.int32), cnt.astype(np.int32),
            s0.astype(np.int32), offadj.astype(np.int32), admit)


def wrap_slot_rows(arrays):
    """``slot_rows``' arrays with lengths whose int32 prefix sums wrap: on
    every fourth read's plus strand every key 2^30 + 7 (the sum passes 2^31
    at the second key and wraps to <= W again past the fourth), on the
    next read's minus strand up to six lengths near 2^31 among the
    crafted ones."""
    gadm, cnt = arrays[0].copy(), arrays[1].copy()
    nk = gadm.shape[2]
    gadm[::4, 0, :] = 2 ** 30 + 7
    cnt[::4, 0, :] = np.arange(nk) % 5 + 1
    big = min(nk, 6)
    gadm[1::4, 1, :big] = 2 ** 31 - 1 - np.arange(big)
    cnt[1::4, 1, :big] = 3
    return (gadm, cnt, *arrays[2:])


def _row(rng, kind: int, W: int, nk: int, cd: int):
    """One row's (diag, toff) lists of at most W valid slots, sorted by
    construction (the caller shuffles them)."""
    d, t = [], []

    def run(start, length, step=0):
        for i in range(length):
            d.append(start + i * step)
            t.append(int(rng.integers(0, nk)))

    if kind == 0:                    # all invalid
        pass
    elif kind == 1:                  # steps exactly at cd, then cd + 1
        x = int(rng.integers(-500, 500))
        for i in range(min(W, 12)):
            d.append(x)
            t.append(i % nk)
            x += cd if i % 4 != 3 else cd + 1
    elif kind == 2:                  # negative diagonals, short chains
        for c in range(int(rng.integers(1, 5))):
            run(-3000 + c * 5 * cd, int(rng.integers(1, 6)))
    elif kind == 3:                  # a key slot repeated within a chain
        x = int(rng.integers(0, 10 ** 6))
        for i in range(min(W, 20)):
            d.append(x + i * (cd // 8))
            t.append(int(rng.integers(0, 3)))
    elif kind == 4:                  # modal-run ties: runs of equal length
        x = int(rng.integers(0, 10 ** 6))
        n = int(rng.integers(2, 5))
        for r in range(n):
            run(x + r * 7, 3)
    elif kind == 5:                  # one long chain (runs past 255 at 512)
        x = int(rng.integers(0, 10 ** 6))
        n = W - int(rng.integers(0, 4))
        pos, i = x, 0
        while i < n:
            ln = int(rng.integers(1, 4)) if i < 280 else int(
                rng.integers(4, 9))
            ln = min(ln, n - i)
            run(pos, ln)
            pos += int(rng.integers(1, 3))
            i += ln
    elif kind == 6:                  # a run longer than 255 slots
        x = int(rng.integers(0, 10 ** 6))
        run(x, min(W, 300))
        if len(d) < W:
            run(x + 5, W - len(d))
    else:                            # random chains, some dense
        x = int(rng.integers(-1000, 10 ** 6))
        n = int(rng.integers(1, W + 1))
        for i in range(n):
            d.append(x)
            t.append(int(rng.integers(0, nk)))
            x += int(rng.choice([0, 0, 1, cd, cd + 1, 3 * cd]))
    return d[:W], t[:W]


def chain_rows(rng, B: int, W: int, nk: int, chain_dist: int):
    """diag, toff (B, 2, W) int32: each row's valid slots shuffled among
    invalid ones (diag 2**30, any key slot), a kind of row for each (read,
    strand) in turn; every eighth read all invalid, every third the same
    row on both strands."""
    diag = np.full((B, 2, W), INVALID, np.int64)
    toff = rng.integers(0, nk, (B, 2, W))
    for b in range(B):
        rows = []
        for h in range(2):
            if h == 1 and b % 3 == 2:
                rows.append(rows[0])
                continue
            if b % 8 == 7:               # the whole read invalid
                kind = 0
            elif W < 256 or b % 2:
                kind = (2 * b + h) % 8
            else:                        # the long chains at W = 512
                kind = 5 + (b // 2 + h) % 3
            rows.append(_row(rng, kind, W, nk, chain_dist))
        for h, (d, t) in enumerate(rows):
            at = rng.permutation(W)[:len(d)] if b % 4 else np.arange(len(d))
            diag[b, h, at] = d
            toff[b, h, at] = t
    return diag.astype(np.int32), toff.astype(np.int32)


def int32_key_fits(diag, toff):
    """(B,) bool: the reads whose rows the register mapping of
    csrc/chain_candidates.cu sorts on its 32-bit key (diag - the row's
    least) << tb | toff: every invalid slot's diagonal 2^30 exactly, every
    valid slot's key slot >= 0, and each row's valid diagonals spanning
    less than 2^(32 - tb) - 1, tb the bit length of the read's largest
    valid key slot. The other reads sort on the int64 key."""
    d = np.asarray(diag, np.int64)
    t = np.asarray(toff, np.int64)
    valid = d < INVALID
    odd = ((~valid) & (d != INVALID)).reshape(len(d), -1).any(1)
    tv = np.where(valid, t, 0).reshape(len(d), -1)
    tb = np.array([int(x).bit_length() for x in tv.max(1, initial=0)],
                  np.int64)
    big = np.iinfo(np.int64).max
    lo = np.where(valid, d, big).min(2, initial=big)
    hi = np.where(valid, d, -big).max(2, initial=-big)
    lim = (np.int64(1) << (32 - tb)) - 1
    fits = (hi < lo) | (hi - lo < lim[:, None])
    return ~odd & (tv.min(1, initial=0) >= 0) & fits.all(1)


def _wide_row(rng, n: int, nk: int, cd: int, lo: int, span: int):
    """n >= 2 valid slots whose diagonals run from lo to lo + span exactly,
    in chains of 1-6 slots (steps of 0 to cd), key slots random with the
    largest (nk - 1) among them."""
    d = [lo, lo + span]
    while len(d) < n:
        c = int(rng.integers(lo, lo + span + 1))
        for _ in range(int(rng.integers(1, 7))):
            if len(d) >= n:
                break
            d.append(min(c, lo + span))
            c += int(rng.integers(0, cd + 1))
    t = rng.integers(0, nk, len(d))
    t[0] = nk - 1
    return d, t


def wide_chain_rows(rng, B: int, W: int, nk: int, chain_dist: int):
    """diag, toff (B, 2, W) int32 as ``chain_rows`` lays them out (valid
    slots shuffled among invalid ones), with the spans of a genome past
    2^27 bases: by read, in turn, both rows spanning from past the limit
    below (and at least 2^27) to ~2^30 from a start at or below 0; one
    row exactly at the 32-bit key's limit (2^(32 - tb) - 2, tb the bit
    length of nk - 1: the key holds it) and the other short; one row one
    past the limit (the int64 key); one row empty and the other wide.
    nk >= 9, so that the limit lies below 2^28."""
    if nk < 9:
        raise ValueError("wide_chain_rows needs nk >= 9")
    lim = (1 << (32 - (nk - 1).bit_length())) - 1
    top = INVALID - 4096
    diag = np.full((B, 2, W), INVALID, np.int64)
    toff = rng.integers(0, nk, (B, 2, W))
    for b in range(B):
        kind = b % 4
        rows = []
        for h in range(2):
            n = int(rng.integers(2, W + 1))
            lo = -int(rng.integers(0, 2000))
            if kind == 0 or (kind == 3 and h == 1):
                span = int(rng.integers(max(1 << 27, lim), top - lo))
            elif kind == 3:
                rows.append(([], []))
                continue
            elif h == 0:
                span = lim - 1 if kind == 1 else lim
            else:
                span = int(rng.integers(0, 10 * chain_dist + 64))
            rows.append(_wide_row(rng, n, nk, chain_dist, lo, span))
        for h, (d, t) in enumerate(rows):
            at = rng.permutation(W)[:len(d)]
            diag[b, h, at] = d
            toff[b, h, at] = t
    return diag.astype(np.int32), toff.astype(np.int32)
